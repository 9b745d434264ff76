"""The reference's run knobs on the port's classify CLI, against the JAX CLI
under the same environment, byte for byte (CPU): the in-flight depth
(``PANGEA_INFLIGHT``) of the fast path's drain queue, a resume mid-run,
and the port's own ``PANGEA_PROFILE`` trace and ``PANGEA_IO_LIB``
library. The port ignores the reference's general-path depth, layout
(``PANGEA_LAYOUT``), bucket widths (``PANGEA_Q8_WAYS``,
``PANGEA_Q12_WAYS``) and pscore form (``PANGEA_PSCORE``) (ROADMAP.md
§C): under each its files still equal the JAX CLI's, since every layout
is exact and both pscore forms agree."""
import json
import shutil

import pytest
import torch

from pangea_tpu import cli as ref_cli
from pangea_tpu.index import build_index
from pangea_tpu_torch import cli
from pangea_tpu_torch.classify import DeviceIndex
from pangea_tpu_torch.index import load_index_any
from pangea_tpu_torch.io import native
from pangea_tpu_torch.index.quot import Q8_WAYS
from pangea_tpu_torch.kernels.score import MAX_PROBES, score_winners_plain
from pangea_tpu_torch.pipeline import run

from .helpers import small_world
from .test_torch_cohort import (DEMUX, assert_same_outputs,
                                assert_same_records, make_cohort, run_both)
from .test_torch_resume import _ids, roll_back

TRIM = ["trim.min_qual=20", "trim.min_len=60"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cohort's files and k=21 w=8 index (make_cohort), a k=31 w=1
    index on its genomes, and the cohort FASTQ three times over (900
    reads) for the deeper pipelines."""
    d = tmp_path_factory.mktemp("torch_knobs")
    make_cohort(d)
    tax, genomes, _, _ = small_world(k=21, seed=4, genome_len=3000,
                                     n_reads=1, read_len=120, w=8)
    build_index(genomes, tax, k=31, w=1).save(str(d / "idx31"))
    lines = (d / "c_1.fastq").read_text().splitlines()
    with open(d / "x3.fastq", "w") as fh:
        for k in range(3):
            for i in range(0, len(lines), 4):
                fh.write(f"{lines[i][:-2]}_{k}\n"
                         + "\n".join(lines[i + 1:i + 4]) + "\n")
    return d


def _args(d, reads="c_1.fastq", index="idx", batch=64, extra=()):
    return ["classify", "--index", str(d / index), "--reads", str(d / reads),
            f"input.batch_size={batch}", "input.max_read_len=140",
            "classify.confidence_threshold=0.05", *extra]


def _same(ref, out):
    names = assert_same_outputs(ref, out)
    assert "manifest.json" in names
    return assert_same_records(ref, out)


@pytest.mark.parametrize("depth", ["2", "3", "8"])
@pytest.mark.parametrize("case", ["demux_trim", "pairs"])
def test_general_path_inflight_depth_byte_identical(world, tmp_path,
                                                    monkeypatch, depth, case):
    """The general path (PANGEA_NO_NATIVE) under PANGEA_INFLIGHT 2, 3 and
    8, which the port ignores there and the reference honours, on 900
    reads in batches of 64 and on 300 pairs in batches of 32: every file,
    and the records' counts."""
    monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    monkeypatch.setenv("PANGEA_INFLIGHT", depth)
    if case == "demux_trim":
        args = _args(world, "x3.fastq", extra=[*TRIM, DEMUX])
    else:
        args = _args(world, batch=32, extra=["--mates",
                                             str(world / "c_2.fastq")])
    ref, out = run_both(args, tmp_path)
    ps = _same(ref, out)
    assert ps["fast_path"] is False and ps["batches"] > int(depth)


@pytest.mark.parametrize("depth", ["1", "8"])
@pytest.mark.parametrize("case", ["demux_trim", "pairs"])
def test_fast_path_inflight_depth_byte_identical(world, tmp_path,
                                                 monkeypatch, depth, case):
    """The fast path's drain queue at PANGEA_INFLIGHT 1 and 8."""
    monkeypatch.setenv("PANGEA_INFLIGHT", depth)
    extra = [*TRIM, DEMUX] if case == "demux_trim" else [
        "--mates", str(world / "c_2.fastq")]
    ref, out = run_both(_args(world, "x3.fastq" if case == "demux_trim"
                              else "c_1.fastq", extra=extra), tmp_path)
    assert _same(ref, out)["fast_path"] is True


def test_general_resume_mid_run_at_depth_4(world, tmp_path, monkeypatch):
    """A general-path run under PANGEA_INFLIGHT=4 rolled back into its
    fifth batch (files torn past it), then resumed: the files equal the
    JAX CLI's uninterrupted run at depth 4."""
    monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    monkeypatch.setenv("PANGEA_INFLIGHT", "4")
    args = _args(world, "x3.fastq", extra=[*TRIM, DEMUX,
                                           "demux.max_mismatch=1"])
    out = tmp_path / "out"
    assert ref_cli.main(args + ["--out", str(out)]) == 0
    shutil.move(str(out), str(tmp_path / "full"))
    assert cli.main(args + ["--out", str(out), "--device", "cpu"]) == 0
    key = str(world / "x3.fastq")
    roll_back(out, key, _ids(world / "x3.fastq"), 300)
    assert cli.main(args + ["--out", str(out), "--device", "cpu",
                            "--resume"]) == 0
    assert_same_outputs(tmp_path / "full", out)
    summary = json.loads((out / "run_summary.json").read_text())
    assert summary["reads_in"] == 600 and summary["fast_path"] is False


@pytest.mark.parametrize("depth", [2, 3])
def test_general_path_drains_each_batch_before_the_next(world, tmp_path,
                                                        monkeypatch, depth):
    """Under any PANGEA_INFLIGHT the port's general path runs in series:
    it drains batch i before it launches batch i + 1, in order (the
    launch and drain order recorded through the launcher and the metrics
    line; ROADMAP.md §C)."""
    monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    monkeypatch.setenv("PANGEA_INFLIGHT", str(depth))
    events = []
    call, end = run._Launcher.__call__, run._end_batch

    def launched(self, bases, mates=None, packed_len=0):
        if self.warmup_sec is not None:
            events.append("launch")
        return call(self, bases, mates, packed_len)

    def drained(state, item, n_cls, line_args):
        events.append("drain")
        return end(state, item, n_cls, line_args)

    monkeypatch.setattr(run._Launcher, "__call__", launched)
    monkeypatch.setattr(run, "_end_batch", drained)
    assert cli.main(_args(world, "x3.fastq") + [
        "--out", str(tmp_path / "out"), "--device", "cpu"]) == 0
    n = -(-900 // 64)
    assert events == ["launch", "drain"] * n
    batches = [json.loads(x)["batch"] for x in
               (tmp_path / "out" / "metrics.jsonl").read_text().splitlines()]
    assert batches == list(range(1, n + 1))


LAYOUTS = {
    "std": ("idx", {"PANGEA_LAYOUT": "std"}),
    "q8": ("idx", {"PANGEA_LAYOUT": "q8"}),
    "q12": ("idx", {"PANGEA_LAYOUT": "q12"}),
    "q12_k31": ("idx31", {"PANGEA_LAYOUT": "q12"}),
    "q8_ways32": ("idx", {"PANGEA_Q8_WAYS": "32"}),
    "q12_ways30": ("idx31", {"PANGEA_LAYOUT": "q12",
                             "PANGEA_Q12_WAYS": "30"}),
    "pscore_quad": ("idx", {"PANGEA_PSCORE": "quad"}),
    "pscore_ranked": ("idx", {"PANGEA_PSCORE": "ranked"}),
    "pscore_ranked_std": ("idx31", {"PANGEA_PSCORE": "ranked"}),
}


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
@pytest.mark.parametrize("case", list(LAYOUTS))
def test_layout_ways_and_pscore_byte_identical(world, tmp_path, monkeypatch,
                                               case, general):
    """PANGEA_LAYOUT where the layout is exact, the q8 and q12 widths and
    the pscore forms, on the pairs, each through both CLIs: the reference
    honours each, the port ignores it, and the files agree."""
    index, env = LAYOUTS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if general:
        monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    ref, out = run_both(_args(world, index=index, extra=[
        "--mates", str(world / "c_2.fastq")]), tmp_path)
    ps = _same(ref, out)
    assert ps["fast_path"] is not general


def test_layout_knobs_leave_the_device_tables_as_auto(world, monkeypatch):
    """The port's tables under the layout knobs: the auto policy's layout
    at Q8_WAYS slots a row; the ``layout`` argument still requests one."""
    idx = load_index_any(str(world / "idx"))
    cpu = torch.device("cpu")
    monkeypatch.setenv("PANGEA_LAYOUT", "std")
    monkeypatch.setenv("PANGEA_Q8_WAYS", "32")
    di = DeviceIndex.from_index(idx, cpu)
    assert (di.cfg.layout, di.cfg.ways) == ("q8", Q8_WAYS)
    for layout in ("std", "q8", "q12"):
        assert DeviceIndex.from_index(idx, cpu,
                                      layout=layout).cfg.layout == layout


@pytest.mark.parametrize("layout,index", [("q8", "idx31"), ("dense", "idx")])
def test_inexact_or_unknown_layout_raises_as_reference(world, tmp_path,
                                                       monkeypatch, layout,
                                                       index):
    """q8 at k=31 (its remainder past 31 bits) and an unknown layout:
    asked for by ``layout``, the port raises the reference CLI's
    ValueError under PANGEA_LAYOUT; the port's CLI ignores the variable
    and writes the JAX CLI's files without it."""
    monkeypatch.setenv("PANGEA_LAYOUT", layout)
    args = _args(world, index=index) + ["mesh.n_data=1", "mesh.n_shard=1"]
    with pytest.raises(ValueError) as want:
        ref_cli.main(args + ["--out", str(tmp_path / "ref_env")])
    with pytest.raises(ValueError) as got:
        DeviceIndex.from_index(load_index_any(str(world / index)),
                               torch.device("cpu"), layout=layout)
    assert str(got.value) == str(want.value)
    monkeypatch.delenv("PANGEA_LAYOUT")
    assert ref_cli.main(args + ["--out", str(tmp_path / "out")]) == 0
    shutil.move(str(tmp_path / "out"), str(tmp_path / "ref"))
    monkeypatch.setenv("PANGEA_LAYOUT", layout)
    assert cli.main(args + ["--out", str(tmp_path / "out"),
                            "--device", "cpu"]) == 0
    _same(tmp_path / "ref", tmp_path / "out")


@pytest.mark.parametrize("impl", ["quad", "ranked"])
def test_pscore_variable_leaves_the_scorer_as_is(monkeypatch, impl):
    """PANGEA_PSCORE leaves the port's scorer as it is: the quadratic
    count up to MAX_PROBES probes a read and the ranked form past it, the
    same outputs as without the variable on either side."""
    g = torch.Generator().manual_seed(3)
    want = {}
    for R in (32, MAX_PROBES + 1):
        t_in = torch.randint(0, 50, (4, R), generator=g, dtype=torch.int32)
        t_out = t_in + torch.randint(1, 30, (4, R), generator=g,
                                     dtype=torch.int32)
        lanes = torch.randint(0, 3, (4, R), generator=g, dtype=torch.int32)
        want[R] = (lanes, t_in, t_out,
                   score_winners_plain(lanes, t_in, t_out, lanes != 0,
                                       False))
    monkeypatch.setenv("PANGEA_PSCORE", impl)
    for R, (lanes, t_in, t_out, out) in want.items():
        got = score_winners_plain(lanes, t_in, t_out, lanes != 0, False)
        for a, b in zip(out, got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mates", [False, True], ids=["single", "pairs"])
@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
def test_profile_writes_a_trace(world, tmp_path, monkeypatch, general,
                                mates):
    """PANGEA_PROFILE=<dir>: a Chrome trace of the steady loop in
    <dir>/trace_rank0.json, carrying the port's spans as user annotations,
    the collected spans' summary in <dir>/spans_rank0.json, and the
    outputs as without it."""
    if general:
        monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    args = _args(world) + (["--mates", str(world / "c_2.fastq")]
                           if mates else [])
    assert cli.main(args + ["--out", str(tmp_path / "plain"),
                            "--device", "cpu"]) == 0
    monkeypatch.setenv("PANGEA_PROFILE", str(tmp_path / "prof"))
    assert cli.main(args + ["--out", str(tmp_path / "out"),
                            "--device", "cpu"]) == 0
    trace = json.loads((tmp_path / "prof" / "trace_rank0.json").read_text())
    assert trace["traceEvents"]
    marks = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    phases = ["parse", "trim", "step", "write", "sync"]
    phases.append("pad" if general else "fetch")
    assert {"step", "step.extract", "step.probe", "step.score",
            *("run." + p for p in phases)} <= marks
    spans = json.loads((tmp_path / "prof" / "spans_rank0.json").read_text())
    assert spans["steps"] == -(-300 // 64) and spans["launches"] == {}
    assert set(spans["self_ms"]) == {"step", "step.extract", "step.probe",
                                     "step.score"}
    for f in ("c_1.assign.tsv", "c_1.summary.tsv"):
        assert (tmp_path / "out" / f).read_bytes() == \
            (tmp_path / "plain" / f).read_bytes()


@pytest.fixture
def fresh_library():
    native.library.cache_clear()
    yield
    native.library.cache_clear()


def test_io_lib_loads_the_named_library(world, tmp_path, monkeypatch,
                                        fresh_library):
    """PANGEA_IO_LIB naming a copy of the built library: it is the one
    loaded, and the fast path's outputs are the JAX CLI's."""
    lib = tmp_path / "lib" / "libpangea_io.so"
    lib.parent.mkdir()
    shutil.copy(native.build(), lib)
    monkeypatch.setenv("PANGEA_IO_LIB", str(lib))
    assert native.library()._name == str(lib)
    ref, out = run_both(_args(world), tmp_path)
    assert _same(ref, out)["fast_path"] is True


@pytest.mark.parametrize("what", ["missing", "not_a_library"])
def test_io_lib_raises_when_unloadable(world, tmp_path, monkeypatch,
                                       fresh_library, what):
    """A missing or unloadable PANGEA_IO_LIB raises: no quiet fall back
    to a built library or to the general path."""
    lib = tmp_path / "libpangea_io.so"
    if what == "not_a_library":
        lib.write_text("not a shared object")
    monkeypatch.setenv("PANGEA_IO_LIB", str(lib))
    with pytest.raises(OSError, match="PANGEA_IO_LIB"):
        native.library()
    with pytest.raises(OSError, match="PANGEA_IO_LIB"):
        cli.main(_args(world) + ["--out", str(tmp_path / "out"),
                                 "--device", "cpu"])
