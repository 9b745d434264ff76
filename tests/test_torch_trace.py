"""The port's tracer (``pangea_tpu_torch/trace.py``) on the CPU: off, it
records nothing; on, the step's spans nest under ``step`` with one step
id, self times subtract the children, the launch-gap and anchor
arithmetic holds on synthetic intervals, ``host_sec`` is the ``run.*``
spans' totals, and placement keeps its record."""
import json
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from pangea_tpu_torch import cli, trace
from pangea_tpu_torch.bench import make_bench_world, make_multik_world
from pangea_tpu_torch.classify import DeviceIndex, pad_batch
from pangea_tpu_torch.dist.mesh import Mesh, MeshConfig, MeshStep
from pangea_tpu_torch.utils import datagen

STEP_SPANS = ("step.extract", "step.probe", "step.score")


@pytest.fixture(scope="module")
def bench():
    return make_bench_world(n_reads=48, read_len=100, n_species=6,
                            genome_len=3000, k=21, w=8)


@pytest.fixture(scope="module")
def multik():
    return make_multik_world(n_reads=48, read_len=100, n_species=6,
                             genome_len=3000)


def _step(indexes, reads):
    mesh = Mesh(MeshConfig(1, 1), "cpu")
    step = MeshStep([DeviceIndex.from_index(ix, "cpu") for ix in indexes],
                    mesh)
    n = len(reads.seqs)
    b = torch.from_numpy(pad_batch(reads.seqs, n, 100))
    m = torch.from_numpy(pad_batch(reads.mates, n, 100))
    return step, b, m


def test_off_records_nothing(bench):
    assert not trace.ON
    assert trace.span("step") is trace.NO_SPAN is trace.span("x")
    step, b, m = _step([bench.index], bench.reads)
    out = step(b, m)
    assert trace._sink is None and not trace._stack()
    with trace.collect() as t:
        pass
    assert t.spans == [] and t.launches == []
    assert t.summary()["steps"] == 0
    totals: dict = {}
    with trace.Span("run.x", totals) as sp:
        time.sleep(0.001)
    assert totals == {"run.x": sp.ns} and sp.trace is None
    with trace.collect():
        again = step(b, m)
    for k in out:
        assert torch.equal(out[k], again[k])


@pytest.mark.parametrize("case", ["one", "multik"])
def test_step_encloses_its_spans_with_one_id(bench, multik, case):
    indexes, reads = (([bench.index], bench.reads) if case == "one"
                      else (multik.indexes, multik.reads))
    step, b, m = _step(indexes, reads)
    with trace.collect() as t:
        for _ in range(3):
            step(b, m)
    steps = [s for s in t.spans if s.name == "step"]
    assert len(steps) == 3 and len({s.step for s in steps}) == 3
    # A multi-k step holds each index's spans in its step.index<i>.
    parts = [] if case == "one" else [f"step.index{i}"
                                      for i in range(len(indexes))]
    for st in steps:
        inner = [s for s in t.spans if s.parent is st]
        names = [s.name for s in inner]
        assert names == (parts or list(STEP_SPANS))
        for part in inner if parts else [st]:
            leaves = [s for s in t.spans if s.parent is part]
            assert [s.name for s in leaves] == list(STEP_SPANS)
            for s in leaves + inner:
                assert s.step == st.step and s.thread == st.thread
                assert st.t0 <= s.t0 <= s.t1 <= st.t1
                assert s.parent.t0 <= s.t0 <= s.t1 <= s.parent.t1
    assert not t.launches                 # the plain versions launch nothing
    got = t.summary()
    assert got["steps"] == 3
    assert set(got["self_ms"]) == {"step", *STEP_SPANS, *parts}
    assert got["launch_block_ms"] is None and got["launch_gap_ms"] is None
    assert got["probe_ms"] is None and got["gaps"] == []
    json.dumps(got)


def test_self_time_is_duration_less_children():
    with trace.collect() as t:
        with trace.span("a") as a:
            with trace.span("b") as b:
                time.sleep(0.002)
                with trace.span("c") as c:
                    time.sleep(0.001)
            with trace.span("b") as b2:
                time.sleep(0.001)
    assert b.parent is a and c.parent is b and b2.parent is a
    own = t.self_times()
    assert own["a"] == (a.ns - b.ns - b2.ns) * 1e-9
    assert own["b"] == (b.ns - c.ns + b2.ns) * 1e-9
    assert own["c"] == c.ns * 1e-9
    assert t.totals()["b"] == (b.ns + b2.ns) * 1e-9


def test_spans_keep_one_stack_a_thread():
    with trace.collect() as t:
        with trace.span("main") as outer:
            done = threading.Event()

            def other():
                with trace.span("drain"):
                    pass
                done.set()
            th = threading.Thread(target=other)
            th.start()
            th.join(10)
            assert done.is_set()
    drain = next(s for s in t.spans if s.name == "drain")
    assert drain.parent is None and outer.parent is None
    assert drain.thread != outer.thread


def test_anchor_puts_device_times_on_the_host_clock():
    # The anchor, recorded at host 10,000,000 ns, lies 4.0 ms after the
    # reference event: an event 1.5 ms after the reference lay 2.5 ms
    # before the anchor.
    assert trace.on_host(1.5, 4.0, 10_000_000) == 7_500_000
    assert trace.on_host(4.0, 4.0, 10_000_000) == 10_000_000
    assert trace.on_host(0.0, 0.25, 1_000) == 1_000 - 250_000


def test_uncovered_gaps_between_intervals():
    assert trace.uncovered([]) == []
    assert trace.uncovered([(0, 10)]) == []
    assert trace.uncovered([(20, 30), (0, 10)]) == [(10, 20)]
    # Overlaps and nesting cover; touching intervals leave no gap.
    assert trace.uncovered([(0, 10), (5, 15), (15, 20), (25, 40),
                            (26, 30), (45, 50)]) == [(20, 25), (40, 45)]


def _span(name, t0, t1, parent=None, step=1):
    return SimpleNamespace(name=name, t0=t0, t1=t1, parent=parent,
                           step=step, thread=1, ns=t1 - t0)


def test_innermost_span_at_a_time():
    st = _span("step", 0, 100)
    sc = _span("step.score", 40, 90, st)
    ln = _span("launch.pangea_score", 80, 85, sc)
    spans = [ln, sc, st]
    assert trace.innermost(spans, 50) == "step.score"
    assert trace.innermost(spans, 82) == "launch.pangea_score"
    assert trace.innermost(spans, 10) == "step"
    assert trace.innermost(spans, 100) is None


def test_summary_assigns_gaps_and_probe_time():
    """Two steps of three launches each: the gaps between a step's launches
    go to the innermost span at their midpoints, the probe's launches give
    probe_ms, and the launch spans give launch_block_ms."""
    t = trace.Trace()

    def launch(name, host, dev, parent):
        sp = _span("launch." + name, host[0], host[1], parent, parent.step)
        t.spans.append(sp)
        rec = trace.Launch(name, sp, 0, None, None)
        rec.t0, rec.t1 = dev
        t.launches.append(rec)

    for k, base in enumerate((0, 1000)):
        sid = k + 1
        st = _span("step", base, base + 400, step=sid)
        ex = _span("step.extract", base + 10, base + 60, st, sid)
        pr = _span("step.probe", base + 60, base + 200, st, sid)
        sc = _span("step.score", base + 200, base + 390, st, sid)
        t.spans += [ex, pr, sc, st]
        launch("pangea_extract_probes", (base + 50, base + 55),
               (base + 52, base + 100), ex)
        # The card idles 100-150 while the host is in step.probe.
        launch("pangea_lookup_std", (base + 140, base + 150),
               (base + 150, base + 300), pr)
        # It idles 300-340 while the host is in step.score.
        launch("pangea_score", (base + 330, base + 338),
               (base + 340, base + 380), sc)
    got = t.summary()
    assert got["steps"] == 2
    assert got["launch_block_ms"] == pytest.approx((5 + 10 + 8) * 1e-6)
    assert got["launch_gap_ms"] == pytest.approx((50 + 40) * 1e-6)
    assert got["probe_ms"] == pytest.approx(150 * 1e-6)
    assert [g[1] for g in got["gaps"]] == ["step.probe"] * 2 + \
        ["step.score"] * 2
    assert got["gaps"][0][0] == pytest.approx(50e-6)
    assert got["launches"] == {"pangea_extract_probes": 2,
                               "pangea_lookup_std": 2, "pangea_score": 2}
    assert got["self_ms"]["step.probe"] == pytest.approx((140 - 10) * 1e-6)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory, bench):
    d = tmp_path_factory.mktemp("torch_trace_cli")
    bench.index.save(str(d / "idx"))
    datagen.write_fastq(str(d / "r_1.fastq"), bench.reads, mate=1)
    datagen.write_fastq(str(d / "r_2.fastq"), bench.reads, mate=2)
    return d


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
def test_host_sec_is_the_run_spans_totals(cli_data, tmp_path, capsys,
                                          monkeypatch, general):
    if general:
        monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    with trace.collect() as t:
        assert cli.main(["classify", "--index", str(cli_data / "idx"),
                         "--reads", str(cli_data / "r_1.fastq"),
                         "--mates", str(cli_data / "r_2.fastq"),
                         "--out", str(tmp_path / "out"), "--device", "cpu",
                         "input.batch_size=16",
                         "input.max_read_len=100"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["fast_path"] is not general
    runs = {k[len("run."):]: v for k, v in t.totals().items()
            if k.startswith("run.")}
    assert result["host_sec"] == runs
    steps = [s for s in t.spans if s.name == "step"]
    assert len(steps) == 3 + 1           # three batches and the warmup
    assert all(s.parent is not None and s.parent.name == "run.step"
               for s in steps[1:])


def test_placement_keeps_its_record(bench):
    before = len(trace.placements())
    with trace.collect() as t:
        DeviceIndex.from_index(bench.index, "cpu")
    rec = trace.placements()[before]
    assert len(trace.placements()) == before + 1
    assert rec["device"] == "cpu"
    assert rec["layout_on"] == "host"
    assert rec["read_bytes"] is None or rec["read_bytes"] >= 0
    assert rec["place"] >= rec["place.layout"] + rec["place.copy"] > 0
    place = {s.name: s for s in t.spans if s.name.startswith("place")}
    assert place["place.layout"].parent is place["place"]
    assert place["place.copy"].parent is place["place"]
    assert rec["place.layout"] == place["place.layout"].ns * 1e-9
