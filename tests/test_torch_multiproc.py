"""The port's classify CLI across processes against the JAX CLI (CPU).

The counterpart of ``tests/test_multiproc.py``: four rank processes of
``python -m pangea_tpu_torch.cli classify`` on a 2 x 2 mesh (two data rows,
two index shards), joined over gloo through a file store, write the
assignments, summaries and stats of the JAX CLI's single-process run byte
for byte, once with the broadcast step and once with the routed step. An
index that the port's own ``build --ooc-shards`` wrote classifies on one
rank as the JAX CLI's monolithic index does.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from pangea_tpu import cli as ref_cli
from pangea_tpu_torch import cli

ROOT = Path(__file__).resolve().parents[1]
OUTPUTS = ("s.assign.tsv", "s.summary.tsv", "stats.json")
RANKS = 4


@pytest.fixture(scope="module")
def testdata(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mp")
    assert ref_cli.main(["gen-testdata", "--out", str(d), "--reads", "500",
                         "--paired"]) == 0
    assert ref_cli.main(["build", "--refs", str(d / "refs.fasta"),
                         "--taxonomy", str(d / "taxonomy.tsv"), "--k", "21",
                         "--out", str(d / "idx21")]) == 0
    assert ref_cli.main(["classify", *_args(d, d / "idx21", d / "ref")]) == 0
    return d


def _args(d, index, out):
    return ["--index", str(index), "--reads", str(d / "reads_1.fastq"),
            "--mates", str(d / "reads_2.fastq"), "--samples", "s",
            "--out", str(out), "input.batch_size=64",
            "input.max_read_len=120", "classify.confidence_threshold=0.05"]


def _same_outputs(a, b):
    for f in OUTPUTS:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize("routing", ["broadcast", "alltoall"])
def test_four_rank_classify_byte_identical(testdata, tmp_path, routing):
    d = testdata
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pangea_tpu_torch.cli", "classify",
         "--device", "cpu", *_args(d, d / "idx21", out), "mesh.n_data=2",
         "mesh.n_shard=2", f"mesh.routing={routing}",
         f"dist.coordinator=file://{tmp_path / 'store'}",
         f"dist.num_processes={RANKS}", f"dist.process_id={r}"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(RANKS)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
        assert f"rank {r} at ({r // 2}, {r % 2})" in err
    _same_outputs(d / "ref", out)
    assert sorted(os.listdir(out)) == sorted([
        *OUTPUTS, "run_config.json", "manifest.json", "metrics.jsonl",
        "run_summary.json"])


def test_port_built_sharded_index_on_one_rank(testdata, tmp_path):
    d = testdata
    assert cli.main(["build", "--refs", str(d / "refs.fasta"), "--taxonomy",
                     str(d / "taxonomy.tsv"), "--k", "21", "--ooc-shards",
                     "4", "--out", str(tmp_path / "idx")]) == 0
    assert cli.main(["classify", "--device", "cpu",
                     *_args(d, tmp_path / "idx", tmp_path / "out")]) == 0
    _same_outputs(d / "ref", tmp_path / "out")
