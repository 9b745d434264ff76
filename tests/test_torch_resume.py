"""``--resume`` on the port's classify CLI against the uninterrupted JAX run
(CPU): a run cut short by a rolled-back manifest with torn files, by a
SIGKILL, before its first checkpoint, started by either package's CLI and
finished by the other's, and on a two-rank gloo mesh, completes to the
same files byte for byte, manifest.json included."""
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pangea_tpu import cli as ref_cli
from pangea_tpu.pipeline.checkpoint import Manifest as RefManifest
from pangea_tpu_torch import cli
from pangea_tpu_torch.pipeline.checkpoint import Manifest

from .test_torch_cohort import (DEMUX, assert_same_outputs, make_cohort)

ROOT = Path(__file__).resolve().parents[1]
TRIM = ["trim.min_qual=20", "trim.min_len=60"]
CASES = {
    "demux_trim": (["--reads", "c_1.fastq"],
                   [*TRIM, DEMUX, "demux.max_mismatch=1"]),
    "pairs_demux_trim": (["--reads", "c_1.fastq", "--mates", "c_2.fastq"],
                         [*TRIM, "trim.max_len=110", DEMUX]),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cohort's world, its FASTQ repeated 32 times (9,600 reads, new
    ids) for the killed runs, and gen-testdata's 150-base reads with a
    k=21 index for truncation."""
    d = tmp_path_factory.mktemp("torch_resume")
    make_cohort(d)
    lines = (d / "c_1.fastq").read_text().splitlines()
    with open(d / "big.fastq", "w") as fh:
        for k in range(32):
            for i in range(0, len(lines), 4):
                fh.write(f"{lines[i][:-2]}_{k}\n" + "\n".join(
                    lines[i + 1:i + 4]) + "\n")
    g = d / "gen"
    assert ref_cli.main(["gen-testdata", "--out", str(g), "--reads",
                         "600"]) == 0
    assert ref_cli.main(["build", "--refs", str(g / "refs.fasta"),
                         "--taxonomy", str(g / "taxonomy.tsv"), "--k", "21",
                         "--out", str(g / "idx21")]) == 0
    return d


def _args(d, reads, extra, batch=64, index="idx"):
    return ["classify", "--index", str(d / index),
            *[str(d / a) if a.endswith((".fastq", ".fasta")) else a
              for a in reads],
            f"input.batch_size={batch}", "input.max_read_len=140",
            "mesh.n_data=1", "mesh.n_shard=1",
            "classify.confidence_threshold=0.05", *extra]


def _run(who, args, out, resume=False):
    tail = ["--out", str(out)] + (["--resume"] if resume else [])
    if who == "jax":
        assert ref_cli.main(args + tail) == 0
    else:
        assert cli.main(args + tail + ["--device", "cpu"]) == 0


def _uninterrupted(args, work):
    """The JAX CLI's whole run in work/out, moved to work/full: the
    resumed runs then write to the same paths."""
    _run("jax", args, work / "out")
    shutil.move(str(work / "out"), str(work / "full"))
    return work / "full"


def _ids(path):
    with open(path) as fh:
        return [ln.split()[0][1:].removesuffix("/1")
                for i, ln in enumerate(fh) if i % 4 == 0]


def roll_back(out, key, ids, done, torn=37):
    """Cut a whole run in ``out`` back to its first ``done`` reads of the
    input ``key`` (read ids ``ids``): the manifest's count, and each
    assignment file's durable offset after its lines of those reads, each
    file torn ``torn`` bytes past it (a crash mid-write). The manifest
    keeps its key order, as a real run's would."""
    first = set(ids[:done])
    man = json.loads((out / "manifest.json").read_text())
    man["files"][key] = done
    for path in man["outputs"]:
        lines = Path(path).read_bytes().splitlines(keepends=True)
        off = sum(len(ln) for ln in lines
                  if ln.split(b"\t")[1].decode() in first)
        man["outputs"][path] = off
        with open(path, "r+b") as fh:
            fh.truncate(min(off + torn, os.path.getsize(path)))
    (out / "manifest.json").write_text(json.dumps(man))
    return man


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
@pytest.mark.parametrize("starter,resumer", [("port", "port"),
                                             ("jax", "port"),
                                             ("port", "jax")])
@pytest.mark.parametrize("case", ["demux_trim", "pairs_demux_trim"])
def test_resume_after_rollback_mid_batch(world, tmp_path, monkeypatch,
                                         case, starter, resumer, general):
    """A manifest rolled back into the second batch (100 reads of 64 a
    batch), the files torn past it: the resumed run (either CLI finishing
    either CLI's run) skips the done reads, cuts the files back and
    completes them; a second resume leaves the assignment files, the
    summaries and the manifest as they were (on the general path, as on
    the reference's, a run with no batch writes stats.json of no
    sample)."""
    if general:
        monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    d = world
    reads, extra = CASES[case]
    args = _args(d, reads, extra)
    full = _uninterrupted(args, tmp_path)
    out = tmp_path / "out"
    _run(starter, args, out)
    key = str(d / "c_1.fastq")
    roll_back(out, key, _ids(d / "c_1.fastq"), 100)
    _run(resumer, args, out, resume=True)
    assert_same_outputs(full, out)
    summary = json.loads((out / "run_summary.json").read_text())
    assert summary["reads_in"] == 200
    metrics = (out / "metrics.jsonl").read_text().splitlines()
    assert json.loads(metrics[-1])["cum_reads"] == 200      # appended
    _run("port", args, out, resume=True)
    for f in os.listdir(full):
        if f.endswith((".tsv", "manifest.json")):
            assert (out / f).read_bytes() == (full / f).read_bytes(), f
    assert json.loads((out / "run_summary.json").read_text())["reads_in"] \
        == 0


def _spawn_port(args, out, env=None, resume=False):
    return subprocess.Popen(
        [sys.executable, "-m", "pangea_tpu_torch.cli", *args,
         "--out", str(out), "--device", "cpu",
         *(["--resume"] if resume else [])],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1", **(env or {})),
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
def test_sigkill_after_two_batches_resume_identical(world, tmp_path,
                                                    monkeypatch, general):
    """A port process killed by SIGKILL once metrics.jsonl has two lines
    (9,600 reads, 150 batches; the fast path commits every batch), then
    resumed: the files equal the uninterrupted JAX run's, and the resumed
    run processes exactly the reads the manifest did not record."""
    env = {"PANGEA_FSYNC_EVERY": "1"}
    if general:
        env["PANGEA_NO_NATIVE"] = "1"
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    d = world
    args = _args(d, ["--reads", "big.fastq"],
                 [*TRIM, DEMUX, "demux.max_mismatch=1"])
    full = _uninterrupted(args, tmp_path)
    out = tmp_path / "out"
    p = _spawn_port(args, out, env)
    metrics = out / "metrics.jsonl"
    deadline = time.time() + 240
    killed = False
    while time.time() < deadline and p.poll() is None:
        if metrics.exists() and metrics.read_text().count("\n") >= 2:
            os.kill(p.pid, signal.SIGKILL)
            killed = True
            break
        time.sleep(0.005)
    _, err = p.communicate(timeout=60)
    assert killed, f"the run ended before two batches:\n{err[-3000:]}"
    assert p.returncode == -signal.SIGKILL
    man = out / "manifest.json"
    done = json.loads(man.read_text())["files"][str(d / "big.fastq")] \
        if man.exists() else 0
    assert done < 9600
    _run("port", args, out, resume=True)
    assert_same_outputs(full, out)
    assert json.loads((out / "run_summary.json").read_text())["reads_in"] \
        == 9600 - done


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
def test_crash_before_first_checkpoint_rewrites(world, tmp_path,
                                                monkeypatch, general):
    """Files written before any manifest record have no durable part: the
    resumed run rewrites them instead of appending."""
    if general:
        monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    d = world
    reads, extra = CASES["demux_trim"]
    args = _args(d, reads, extra)
    full = _uninterrupted(args, tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    for f in os.listdir(full):
        if f.endswith(".assign.tsv"):
            whole = (full / f).read_bytes()
            (out / f).write_bytes(whole[:len(whole) // 3 + 7])
    shutil.copy(full / "run_config.json", out)
    _run("port", args, out, resume=True)
    assert_same_outputs(full, out)


@pytest.mark.parametrize("resumer", ["port", "jax"])
def test_resume_truncation_not_counted_twice(world, tmp_path, resumer):
    """Reads of 150 bases at max_read_len 120 are all cut on the fast path:
    a run resumed after 128 durable reads counts only its own."""
    g = world / "gen"
    args = ["classify", "--index", str(g / "idx21"),
            "--reads", str(g / "reads_1.fastq"), "--samples", "s",
            "input.batch_size=64", "input.max_read_len=120",
            "mesh.n_data=1", "mesh.n_shard=1"]
    full = _uninterrupted(args, tmp_path)
    whole = json.loads((full / "run_summary.json").read_text())
    assert whole["truncated_reads"] == whole["reads"] == 600
    out = tmp_path / "out"
    _run("port", args, out)
    port_whole = json.loads((out / "run_summary.json").read_text())
    assert port_whole["truncated_reads"] == 600
    roll_back(out, str(g / "reads_1.fastq"), _ids(g / "reads_1.fastq"), 128,
              torn=0)
    _run(resumer, args, out, resume=True)
    rs = json.loads((out / "run_summary.json").read_text())
    assert rs["reads"] == 600 - 128 == rs["truncated_reads"]
    assert_same_outputs(full, out)


@pytest.mark.parametrize("general", [False, True], ids=["fast", "general"])
def test_resume_on_two_rank_gloo_mesh(world, tmp_path, monkeypatch, general):
    """Two rank processes (mesh 2 x 1 over gloo) resume a run rolled back
    mid-batch: both skip the reads of rank 0's manifest, rank 0 alone
    writes, and the files equal the JAX CLI's single-process run's."""
    if general:
        monkeypatch.setenv("PANGEA_NO_NATIVE", "1")
    d = world
    reads, extra = CASES["pairs_demux_trim"]
    args = _args(d, reads, extra)
    full = _uninterrupted(args, tmp_path)
    out = tmp_path / "out"
    _run("port", args, out)
    roll_back(out, str(d / "c_1.fastq"), _ids(d / "c_1.fastq"), 100)
    mesh_args = [a for a in args if not a.startswith("mesh.")] + [
        "mesh.n_data=2", "mesh.n_shard=1",
        f"dist.coordinator=file://{tmp_path / 'store'}",
        "dist.num_processes=2"]
    procs = [_spawn_port(mesh_args + [f"dist.process_id={r}"], out,
                         resume=True) for r in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=300)[1].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
    assert_same_outputs(full, out)
    summary = json.loads((out / "run_summary.json").read_text())
    assert summary["reads_in"] == 200 and summary["mesh"] == {"data": 2,
                                                              "shard": 1}


def test_manifest_writes_the_reference_json(tmp_path):
    """The same records give the same manifest bytes; each loads the
    other's; resume=False starts anew; truncation cuts recorded files and
    skips missing ones; no temporary file is left."""
    paths = [str(tmp_path / f"{n}.tsv") for n in ("b", "a", "c")]
    for p in paths:
        Path(p).write_bytes(b"x" * 100)
    ours = Manifest(str(tmp_path / "ours.json"))
    ref = RefManifest(str(tmp_path / "ref.json"))
    for m in (ours, ref):
        m.record_batch("r1.fq", 64, {paths[0]: 10, paths[1]: 20})
        m.record_batch("r1.fq", 36, {paths[1]: 25, paths[2]: 0})
        m.record_batch("r2.fq", 7, {})
    assert (tmp_path / "ours.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["a.tsv", "b.tsv", "c.tsv", "ours.json", "ref.json"])
    loaded = Manifest.load_or_new(str(tmp_path / "ref.json"), True)
    assert loaded.state == ref.state and loaded.reads_done("r1.fq") == 100
    assert loaded.reads_done("other.fq") == 0
    assert Manifest.load_or_new(str(tmp_path / "ref.json"), False).state \
        == {"files": {}, "outputs": {}}
    os.unlink(paths[2])
    loaded.truncate_outputs()
    assert [os.path.getsize(p) for p in paths[:2]] == [10, 25]
    assert not os.path.exists(paths[2])
