"""The multi-k step's per-index tracing (``pangea_tpu_torch/trace.py``
``IndexSpan``, ``lookup_taken``, ``index_steps``) on the CPU: each index's part is a
``step.index<i>`` span under ``step`` around its own extract, probe and
score spans; its calls, probes and sorted lookups are totalled whether or
not a trace is collected; a one-index step records nothing; the gap labels
name the index; and the benchmark's ``later_index_enqueue_ms`` reader
reads the totals."""
import importlib.util
import os
from types import SimpleNamespace

import pytest
import torch

from pangea_tpu_torch import trace
from pangea_tpu_torch.bench import make_bench_world, make_multik_world
from pangea_tpu_torch.classify import (DeviceIndex, MultiKClassifier,
                                       pad_batch)
from pangea_tpu_torch.dist.mesh import Mesh, MeshConfig, MeshStep
from pangea_tpu_torch.kernels import lookup as LK

READ_LEN = 100
STEP_SPANS = ("step.extract", "step.probe", "step.score")
READER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks", "metrics",
    "later_index_enqueue_ms.py")


@pytest.fixture(scope="module")
def multik():
    return make_multik_world(n_reads=32, read_len=READ_LEN, n_species=6,
                             genome_len=3000)


@pytest.fixture(scope="module")
def bench():
    return make_bench_world(n_reads=32, read_len=READ_LEN, n_species=6,
                            genome_len=3000, k=21, w=8)


@pytest.fixture(autouse=True)
def fresh_totals(monkeypatch):
    """Each test starts from no per-index totals."""
    monkeypatch.setattr(trace, "_index_steps", {})


def _step(indexes, reads):
    mesh = Mesh(MeshConfig(1, 1), "cpu")
    dis = [DeviceIndex.from_index(ix, "cpu") for ix in indexes]
    n = len(reads.seqs)
    b = torch.from_numpy(pad_batch(reads.seqs, n, READ_LEN))
    m = torch.from_numpy(pad_batch(reads.mates, n, READ_LEN))
    return MeshStep(dis, mesh), dis, b, m


def _columns(k: int, w: int) -> int:
    return 2 * ((READ_LEN - k + 1) // w)         # both mates


def _reader():
    spec = importlib.util.spec_from_file_location("later_index_reader",
                                                  READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_index_spans_nest_under_step_around_their_probe(multik):
    step, dis, b, m = _step(multik.indexes, multik.reads)
    with trace.collect() as t:
        step(b, m)
    st, = [s for s in t.spans if s.name == "step"]
    parts = [s for s in t.spans if s.parent is st]
    assert [s.name for s in parts] == ["step.index0", "step.index1"]
    assert parts[0].t1 <= parts[1].t0
    for part in parts:
        assert part.step == st.step
        assert st.t0 <= part.t0 <= part.t1 <= st.t1
        inner = [s for s in t.spans if s.parent is part]
        assert [s.name for s in inner] == list(STEP_SPANS)
        probe = inner[1]
        assert part.t0 <= probe.t0 <= probe.t1 <= part.t1
    own = t.summary()["self_ms"]
    assert {"step.index0", "step.index1"} <= set(own)
    assert all(v >= 0 for v in own.values())


@pytest.mark.parametrize("path", ["unsorted", "sorted"])
def test_index_steps_count_calls_probes_and_sorted_lookups(multik,
                                                           monkeypatch,
                                                           path):
    step, dis, b, m = _step(multik.indexes, multik.reads)
    if path == "sorted":
        monkeypatch.setattr(LK, "_DEEP_ROWS", 1 << 9)
        monkeypatch.setattr(
            LK, "_deep_chunk",
            lambda n, nb, rb=512, min_chunk=8192: 256 if n > 256 else None)
        assert all(di.fused.shape[0] > LK._DEEP_ROWS for di in dis)
    n_steps = 3
    for _ in range(n_steps):                   # the tracer off
        step(b, m)
    recs = trace.index_steps()
    assert [r["index"] for r in recs] == [0, 1]
    B = b.shape[0]
    for rec, di in zip(recs, dis):
        cfg = di.cfg
        assert (rec["k"], rec["w"], rec["layout"]) == (cfg.k, cfg.w,
                                                       cfg.layout)
        assert rec["calls"] == n_steps
        assert rec["probes"] == n_steps * B * _columns(cfg.k, cfg.w)
        assert rec["sorted"] == (n_steps if path == "sorted" else 0)
        assert rec["host_s"] > 0
    # The one-device multi-k step shares the fold, and its totals.
    MultiKClassifier(dis)(b, m)
    assert [r["calls"] for r in trace.index_steps()] == [n_steps + 1] * 2


def test_one_index_step_records_nothing(bench):
    step, _, b, m = _step([bench.index], bench.reads)
    step(b, m)
    with trace.collect() as t:
        step(b, m)
    assert trace.index_steps() == []
    assert not any(s.name.startswith(trace.INDEX) for s in t.spans)


def test_off_span_is_the_shared_no_op(multik):
    assert not trace.ON
    assert trace.span("step.index0") is trace.NO_SPAN
    step, _, b, m = _step(multik.indexes, multik.reads)
    step(b, m)
    assert trace._sink is None and not trace._stack()
    assert trace.span("step") is trace.NO_SPAN
    # The totals' own span records no trace while none is collected, and
    # counts lookups only while it is open.
    sp = trace.IndexSpan(0, 21, 7, "q8")
    with sp:
        assert trace.open_index is sp.record
        trace.lookup_taken(10, False)
    assert sp.trace is None and sp.ns > 0
    assert trace.open_index is None
    rec, = [r for r in trace.index_steps() if r["w"] == 7]
    assert (rec["calls"], rec["probes"], rec["sorted"]) == (1, 10, 0)


def test_innermost_names_the_index():
    def sp(name, t0, t1, parent=None):
        return SimpleNamespace(name=name, t0=t0, t1=t1, parent=parent)
    step = sp("step", 0, 100)
    i0 = sp("step.index0", 0, 50, step)
    i1 = sp("step.index1", 50, 100, step)
    probe0 = sp("step.probe", 10, 20, i0)
    probe1 = sp("step.probe", 60, 70, i1)
    spans = [step, i0, i1, probe0, probe1]
    assert trace.innermost(spans, 15) == "step.index0+step.probe"
    assert trace.innermost(spans, 65) == "step.index1+step.probe"
    assert trace.innermost(spans, 55) == "step.index1"
    assert trace.innermost(spans, 150) is None
    one = sp("step", 0, 10)
    assert trace.innermost([one, sp("step.probe", 2, 4, one)],
                           3) == "step.probe"


def test_later_index_enqueue_ms_reads_the_totals(multik, bench):
    read = _reader()
    assert read(None) is None                        # no records
    step, _, b, m = _step([bench.index], bench.reads)
    step(b, m)
    assert read(None) is None                        # a one-index step
    step, _, b, m = _step(multik.indexes, multik.reads)
    for _ in range(2):
        step(b, m)
    recs = trace.index_steps()
    got = read(None)
    assert got > 0
    assert got == pytest.approx(recs[1]["host_s"] / recs[0]["calls"] * 1e3)
