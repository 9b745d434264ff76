"""The port's classify CLI against the JAX CLI on the same files (CPU)."""
import json
import os

import pytest

from pangea_tpu import cli as ref_cli
from pangea_tpu.index import build_index
from pangea_tpu.utils import datagen
from pangea_tpu_torch import cli

from .helpers import small_world


@pytest.fixture(scope="module")
def testdata(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    tax, genomes, idx, rs = small_world(k=21, seed=4, genome_len=3000,
                                        n_reads=150, read_len=120,
                                        paired=True, w=8)
    idx.save(str(d / "idx"))
    # Config 4's second index: k=31 on the same genomes and taxonomy.
    build_index(genomes, tax, k=31).save(str(d / "idx31"))
    # An index built against another taxonomy (one more genus a phylum).
    otax = datagen.make_taxonomy(genera_per_phylum=3)
    other = build_index(datagen.make_genomes(otax, genome_len=1000, seed=1),
                        otax, k=21)
    assert other.meta.taxonomy_hash != idx.meta.taxonomy_hash
    other.save(str(d / "idx_other"))
    datagen.write_fastq(str(d / "a_1.fastq"), rs, mate=1)
    datagen.write_fastq(str(d / "a_2.fastq"), rs, mate=2)
    half = datagen.ReadSet(ids=rs.ids[:60], seqs=rs.seqs[:60], mates=None,
                           truth=rs.truth[:60])
    datagen.write_fastq(str(d / "b.fastq"), half, mate=1)
    return d


@pytest.mark.parametrize("indexes,reads", [
    (["idx"], ["--reads", "a_1.fastq", "--mates", "a_2.fastq",
               "--samples", "s"]),
    (["idx"], ["--reads", "a_1.fastq", "b.fastq"]),
    (["idx", "idx31"], ["--reads", "a_1.fastq", "--mates", "a_2.fastq",
                        "--samples", "s"]),
], ids=["paired", "two_single_files", "multi_index"])
def test_cli_outputs_byte_identical_to_jax(testdata, tmp_path, monkeypatch,
                                           indexes, reads):
    d = testdata
    monkeypatch.setenv("PANGEA_NO_NATIVE", "1")  # the reference's general path
    args = ["classify", "--index", *[str(d / i) for i in indexes],
            *[str(d / a) if a.endswith(".fastq") else a for a in reads],
            "input.batch_size=64", "input.max_read_len=120",
            "mesh.n_data=1", "mesh.n_shard=1",
            "classify.confidence_threshold=0.05"]
    ref_out, out = tmp_path / "ref", tmp_path / "port"
    assert ref_cli.main(args + ["--out", str(ref_out)]) == 0
    assert cli.main(args + ["--out", str(out), "--device", "cpu"]) == 0
    names = sorted(f for f in os.listdir(ref_out)
                   if f.endswith(".tsv") or f == "stats.json")
    assert any(f.endswith(".assign.tsv") for f in names)
    assert any(f.endswith(".summary.tsv") for f in names)
    for f in names:
        assert (out / f).read_bytes() == (ref_out / f).read_bytes(), f


@pytest.mark.parametrize("extra", [
    ["mesh.n_data=2", "mesh.n_shard=1"],
], ids=["mesh"])
def test_cli_unsupported_options_raise(testdata, tmp_path, extra):
    """A mesh runs (tests/test_torch_dist.py) but must cover the world of
    ranks, here one process. (Trim, demux, max_len and resume run:
    tests/test_torch_cohort.py and tests/test_torch_resume.py.)"""
    d = testdata
    args = ["classify", "--index", str(d / "idx"),
            "--reads", str(d / "a_1.fastq"), "--mates", str(d / "a_2.fastq"),
            "--out", str(tmp_path / "out"), "--device", "cpu",
            "input.batch_size=64", "input.max_read_len=120", *extra]
    with pytest.raises(ValueError, match="mesh 2 x 1 for a world of 1 ranks"):
        cli.main(args)


def test_cli_refuses_indexes_of_different_taxonomies(testdata, tmp_path):
    d = testdata
    with pytest.raises(ValueError, match="multi-k indexes built against "
                                         "different taxonomies"):
        cli.main(["classify", "--index", str(d / "idx"),
                  str(d / "idx_other"), "--reads", str(d / "a_1.fastq"),
                  "--out", str(tmp_path / "out"), "--device", "cpu",
                  "input.batch_size=64", "input.max_read_len=120"])


def test_cli_reports_host_time_by_phase(testdata, tmp_path, capsys,
                                        monkeypatch):
    """Each path reports its own phases: the general loop's parse, trim,
    pad, step, write and sync sum to at most the wall; the fast path's
    threads (parse and trim, step, fetch and write, sync) overlap, so each
    is at most the wall."""
    d = testdata
    for env, phases in ((None, ["fetch", "parse", "step", "sync", "trim",
                                "write"]),
                        ("1", ["pad", "parse", "step", "sync", "trim",
                               "write"])):
        if env:
            monkeypatch.setenv("PANGEA_NO_NATIVE", env)
        assert cli.main(["classify", "--index", str(d / "idx"),
                         "--reads", str(d / "a_1.fastq"),
                         "--mates", str(d / "a_2.fastq"),
                         "--out", str(tmp_path / f"out{env}"),
                         "--device", "cpu", "input.batch_size=64",
                         "input.max_read_len=120"]) == 0
        result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert result["fast_path"] is (env is None)
        assert result["reads"] == 150 and result["batches"] == 3
        assert result["truncated_reads"] == 0
        host = result["host_sec"]
        assert sorted(host) == phases
        assert all(0 < v <= result["wall_sec"] + 1e-3 for v in host.values())
        if env:
            assert sum(host.values()) <= result["wall_sec"] + 1e-3
