"""The port's ``gen-testdata`` and ``build`` against the JAX CLI's (CPU).

Each subcommand runs in both CLIs on the same arguments and must write the
same files, byte for byte; ``taxonomy.npz`` is a zip whose entries carry a
time stamp, so it is compared by its arrays and the taxonomy's content
hash. The port-built index then classifies as the JAX-built one does.
"""
import os

import numpy as np
import pytest

from pangea_tpu import cli as ref_cli
from pangea_tpu.taxonomy import Taxonomy as RefTaxonomy
from pangea_tpu_torch import cli
from pangea_tpu_torch.index import load_index_any
from pangea_tpu_torch.taxonomy import Taxonomy

GEN = ["--reads", "300", "--read-len", "120", "--genome-len", "3000",
       "--paired", "--seed", "4"]
INDEX_FILES = ("meta.json", "key_hi.npy", "key_lo.npy", "val.npy",
               "stash.npy")


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    return names


@pytest.mark.parametrize("extra,files", [
    ([], ["reads_1.fastq", "reads_2.fastq", "refs.fasta", "taxonomy.tsv",
          "truth.tsv"]),
    (["--bulk", "--n-samples", "2"],
     ["barcodes.tsv", "reads_1.fastq", "reads_1.fastq.samples.npy",
      "reads_1.fastq.truth.npy", "reads_2.fastq", "refs.fasta",
      "taxonomy.tsv"])], ids=["sampled", "bulk_pooled"])
def test_gen_testdata_byte_identical(tmp_path, extra, files):
    ref, port = tmp_path / "ref", tmp_path / "port"
    assert ref_cli.main(["gen-testdata", "--out", str(ref), *GEN,
                         *extra]) == 0
    assert cli.main(["gen-testdata", "--out", str(port), *GEN, *extra]) == 0
    assert _same_tree(ref, port) == files


@pytest.fixture(scope="module")
def testdata(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_build")
    assert ref_cli.main(["gen-testdata", "--out", str(d), *GEN]) == 0
    return d


@pytest.mark.parametrize("args", [
    ["--k", "21"], ["--k", "31", "--minimizer-w", "4", "--ways", "32"],
    ["--k", "15", "--load-factor", "0.8"]], ids=["k21", "k31_w4", "k15"])
def test_build_byte_identical(testdata, tmp_path, args):
    """meta.json and the four arrays byte for byte; the taxonomy by its
    arrays, names and content hash."""
    d = testdata
    common = ["build", "--refs", str(d / "refs.fasta"), "--taxonomy",
              str(d / "taxonomy.tsv"), *args]
    ref, port = tmp_path / "ref", tmp_path / "port"
    assert ref_cli.main(common + ["--out", str(ref)]) == 0
    assert cli.main(common + ["--out", str(port)]) == 0
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) \
        == sorted([*INDEX_FILES, "taxonomy.npz"])
    for name in INDEX_FILES:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    want = RefTaxonomy.load(str(ref / "taxonomy.npz"))
    got = Taxonomy.load(str(port / "taxonomy.npz"))
    with np.load(ref / "taxonomy.npz", allow_pickle=True) as a, \
            np.load(port / "taxonomy.npz", allow_pickle=True) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])
    assert got.content_hash() == want.content_hash()
    assert load_index_any(str(port)).meta.n_kmers > 1000


def test_classify_on_the_port_built_index(testdata, tmp_path, monkeypatch):
    """The port's classify on the port-built index writes what the JAX
    CLI's classify writes on the JAX-built one."""
    d = testdata
    monkeypatch.setenv("PANGEA_NO_NATIVE", "1")  # the reference's general path
    build = ["build", "--refs", str(d / "refs.fasta"), "--taxonomy",
             str(d / "taxonomy.tsv"), "--k", "21", "--minimizer-w", "8"]
    assert ref_cli.main(build + ["--out", str(tmp_path / "ref_idx")]) == 0
    assert cli.main(build + ["--out", str(tmp_path / "port_idx")]) == 0
    reads = ["--reads", str(d / "reads_1.fastq"), "--mates",
             str(d / "reads_2.fastq"), "--samples", "s",
             "input.batch_size=64", "input.max_read_len=120",
             "classify.confidence_threshold=0.05"]
    ref_out, out = tmp_path / "ref", tmp_path / "port"
    assert ref_cli.main(["classify", "--index", str(tmp_path / "ref_idx"),
                         *reads, "--out", str(ref_out)]) == 0
    assert cli.main(["classify", "--index", str(tmp_path / "port_idx"),
                     *reads, "--out", str(out), "--device", "cpu"]) == 0
    for f in ("s.assign.tsv", "s.summary.tsv", "stats.json"):
        assert (out / f).read_bytes() == (ref_out / f).read_bytes(), f
    lines = (out / "s.assign.tsv").read_text().splitlines()
    assert len(lines) == 300 and sum(x.split("\t")[2] != "0"
                                     for x in lines) > 200


def test_build_ooc_shards_raises(testdata, tmp_path):
    """``build --ooc-shards 2`` (it raised before the port ran sharded
    indexes) writes the JAX CLI's sharded directory, byte for byte, and
    the port loads it as a ShardedIndex of the monolithic build's k-mers.
    ``tests/test_torch_shard.py`` covers more shard counts."""
    d = testdata
    common = ["build", "--refs", str(d / "refs.fasta"), "--taxonomy",
              str(d / "taxonomy.tsv"), "--ooc-shards", "2"]
    ref, port = tmp_path / "ref", tmp_path / "port"
    assert ref_cli.main(common + ["--out", str(ref)]) == 0
    assert cli.main(common + ["--out", str(port)]) == 0
    for shard in ("shard000", "shard001"):
        assert _same_tree(ref / shard, port / shard) == [
            f"{name}.npy" for name in ("key_hi", "key_lo", "stash", "val")]
    meta = "meta.json"
    assert (port / meta).read_bytes() == (ref / meta).read_bytes()
    sidx = load_index_any(str(port))
    mono = tmp_path / "mono"
    assert cli.main(common[:5] + ["--out", str(mono)]) == 0
    assert sidx.meta.n_shards == 2 \
        and sidx.meta.n_kmers == load_index_any(str(mono)).meta.n_kmers
