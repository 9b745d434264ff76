"""The std layout and the big-taxonomy LCA against JAX and golden (CPU).

Three small worlds cover the branches: the bench genomes (cut to 1.5 kb)
on a 66,563-taxon tree (std, wide rows, binary-lifting LCA from taxon
lanes), on the bench's own tree at k=31 (std, packed rows, direct LCA) and
on a 5,251-taxon tree (q8, lifting LCA from tins). Inputs come from numpy
seeds; every output is an integer, so the tolerance is exact equality.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu import cli as ref_cli
from pangea_tpu.classify.engine import DeviceIndex as RefDeviceIndex
from pangea_tpu.classify.engine import make_classify_fn as ref_classify_fn
from pangea_tpu.golden import classify_reads_golden
from pangea_tpu.index import build_index as ref_build_index
from pangea_tpu.kernels.lookup import fuse_stash as ref_fuse_stash
from pangea_tpu.kernels.lookup import fuse_table as ref_fuse_table
from pangea_tpu.kernels.lookup import lookup_jnp
from pangea_tpu.kernels.score import lca_pairs_jnp, score_reads_jnp
from pangea_tpu.taxonomy import Taxonomy as RefTaxonomy
from pangea_tpu.utils import datagen as ref_datagen
from pangea_tpu_torch import cli
from pangea_tpu_torch.bench import make_bench_world, write_fastq_pair
from pangea_tpu_torch.classify import Classifier, DeviceIndex, pad_batch
from pangea_tpu_torch.classify.engine import TAX_KEYS
from pangea_tpu_torch.index import extract_pairs
from pangea_tpu_torch.index.build import layout_table
from pangea_tpu_torch.kernels import (fuse_stash, fuse_table,
                                      lca_pairs_plain, lookup_std,
                                      score_reads_taxon)

READ_LEN, N_READS = 100, 64
# name -> (k, w, tree, layout the port must pick, T + 1 > 4096)
WORLDS = {"wide": (21, 1, (512, 64), "std", True),
          "k31_packed": (31, 8, None, "std", False),
          "q8_lifting": (21, 1, (64, 40), "q8", True)}


def _ref_index(k, w, tree):
    """The same world through the reference's builder (golden needs its
    Index)."""
    shape = tree or (8, 3)
    tax = ref_datagen.make_taxonomy(2, *shape, seed=0)
    if tree:
        ids = {name: t for t, name in enumerate(tax.names)}
        tax.species_ids = [ids[f"Species_{p}_{g}_{s}"] for p in range(2)
                           for g in range(8) for s in range(3)]
    genomes = ref_datagen.make_genomes(tax, genome_len=1500, seed=1)
    return ref_build_index(genomes, tax, k=k, w=w, ways=0)


@pytest.fixture(scope="module", params=list(WORLDS))
def world(request):
    k, w, tree, layout, big = WORLDS[request.param]
    bw = make_bench_world(n_reads=N_READS, read_len=READ_LEN,
                          genome_len=1500, k=k, w=w, tree=tree)
    ref = _ref_index(k, w, tree)
    for name in ("key_hi", "key_lo", "val", "stash"):
        np.testing.assert_array_equal(getattr(bw.index, name),
                                      getattr(ref, name))
    assert (bw.taxonomy.num_taxa + 1 > 4096) == big
    return bw, ref, layout


def _batch(rs):
    return (pad_batch(rs.seqs, N_READS, READ_LEN),
            pad_batch(rs.mates, N_READS, READ_LEN))


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("thr", [0.0, 0.05])
def test_classifier_matches_jax_and_golden(world, paired, thr):
    bw, ref_idx, layout = world
    rs = bw.reads
    b1, b2 = _batch(rs)
    di = DeviceIndex.from_index(bw.index, "cpu", thr)
    assert di.cfg.layout == layout
    got = Classifier(di)(torch.from_numpy(b1),
                         torch.from_numpy(b2) if paired else None)
    ref = RefDeviceIndex.from_index(ref_idx, confidence_threshold=thr)
    assert ref.cfg.layout == layout
    args = (jnp.asarray(b1), jnp.asarray(b2)) if paired else \
        (jnp.asarray(b1),)
    want = ref_classify_fn(ref.cfg, paired=paired)(ref.tables, *args)
    gold = classify_reads_golden(rs.seqs, ref_idx, thr,
                                 mates=rs.mates if paired else None)
    for key in ("taxon", "best", "nvalid"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
        np.testing.assert_array_equal(got[key].numpy(),
                                      [getattr(g, key) for g in gold])
    assert (got["taxon"] != 0).sum() > N_READS // 2


def test_numpy_tables_carry_over(world):
    """from_numpy_tables(the reference's tables) == from_index."""
    bw, ref_idx, layout = world
    ref = RefDeviceIndex.from_index(ref_idx, confidence_threshold=0.05,
                                    layout=layout, device_put=False)
    a = DeviceIndex.from_numpy_tables(ref.tables, ref.cfg, "cpu")
    b = DeviceIndex.from_index(bw.index, "cpu", 0.05)
    assert a.cfg == b.cfg
    for x, y in ((a.fused, b.fused), (a.stash, b.stash),
                 *((a.tax[k], b.tax[k]) for k in TAX_KEYS)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _probes(idx, seed=2):
    canon, _ = extract_pairs(idx)
    rng = np.random.default_rng(seed)
    absent = rng.integers(0, 1 << 42, size=2000, dtype=np.uint64)
    keys = np.concatenate([canon, absent])
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    valid = rng.random(keys.shape[0]) < 0.85
    return hi, lo, valid, canon.shape[0]


@pytest.mark.parametrize("tree,ways,load_factor", [
    (None, 16, 0.5), ((512, 64), 32, 0.5), ((512, 64), 4, 4.0)],
    ids=["packed", "wide", "forced_stash"])
def test_lookup_std_matches_jax(tree, ways, load_factor):
    bw = make_bench_world(n_reads=1, read_len=READ_LEN, genome_len=1500,
                          k=21, w=1, tree=tree)
    tax = bw.taxonomy
    canon, taxa = extract_pairs(bw.index)
    kh, kl, val, st, _ = layout_table(canon, taxa, load_factor, ways=ways)
    fused = fuse_table(kh, kl, val, tax.tin, tax.tout)
    stash = fuse_stash(st, tax.tin, tax.tout)
    np.testing.assert_array_equal(fused, ref_fuse_table(kh, kl, val, tax.tin,
                                                        tax.tout))
    np.testing.assert_array_equal(stash, ref_fuse_stash(st, tax.tin,
                                                        tax.tout))
    assert fused.shape[1] == (4 if tree is None else 6) * ways
    if load_factor > 1:
        assert stash.shape[1] > 0, "stash not exercised"
    hi, lo, valid, n = _probes(bw.index)
    got = lookup_std(*(torch.from_numpy(a) for a in
                       (hi.view(np.int32), lo.view(np.int32), valid,
                        fused.view(np.int32), stash.view(np.int32))), ways)
    want = lookup_jnp(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
                      jnp.asarray(fused), jnp.asarray(stash), ways=ways)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    hits = got[0][:n][torch.from_numpy(valid[:n])]
    assert int(hits.min()) > 0
    assert not got[0][n:].any()


@pytest.mark.parametrize("tree", [None, (512, 64)], ids=["direct",
                                                         "lifting"])
@pytest.mark.parametrize("thr", [0.0, 0.3, 1.0])
def test_score_reads_taxon_matches_jax(tree, thr):
    shape = tree or (8, 3)
    tax = ref_datagen.make_taxonomy(2, *shape, seed=0)
    rng = np.random.default_rng(int(thr * 10) + len(shape))
    B, R = 200, 40
    # Taxa from a few lineages, so reads have ties and nested winners.
    lineage = rng.integers(1, tax.num_taxa + 1, size=(B, 4))
    taxa = lineage[np.arange(B)[:, None], rng.integers(0, 4, size=(B, R))]
    taxa = np.where(rng.random((B, R)) < 0.3, tax.parent[taxa], taxa)
    taxon = np.where(rng.random((B, R)) < 0.5, taxa, 0).astype(np.int32)
    taxon[:10] = 0                                     # reads with no hit
    t_in = np.where(taxon != 0, tax.tin[taxon], 0).astype(np.int32)
    t_out = np.where(taxon != 0, tax.tout[taxon], 0).astype(np.int32)
    valid = rng.random((B, R)) < 0.8
    valid[10:20] = False                               # nvalid = 0
    valid |= taxon != 0
    valid[10:20] = False
    arrays = tax.device_arrays()
    got = score_reads_taxon(
        *(torch.from_numpy(a) for a in (taxon, t_in, t_out, valid)),
        {k: torch.from_numpy(v) for k, v in arrays.items()}, thr)
    want = score_reads_jnp(
        (jnp.asarray(taxon), jnp.asarray(t_in), jnp.asarray(t_out)),
        jnp.asarray(valid.sum(1).astype(np.int32)),
        {k: jnp.asarray(v) for k, v in arrays.items()}, thr)
    for g, key in zip(got, ("taxon", "best", "nvalid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[key]))
    assert (got[0][:20].numpy() == 0).all()
    assert thr > 0 or (got[0].numpy() != 0).sum() > B // 2
    assert thr == 1.0 or (got[0].numpy() != 0).any()


def _chain(n):
    parent = np.arange(-1, n, dtype=np.int32)
    parent[:2] = (0, 1)
    return RefTaxonomy(parent=parent, rank=np.zeros(n + 1, np.int8),
                       names=["unclassified"] + [f"n{i}"
                                                 for i in range(1, n + 1)])


@pytest.mark.parametrize("which", ["chain", "tree"])
def test_lca_pairs_matches_jax_and_numpy(which):
    tax = _chain(5000) if which == "chain" else \
        ref_datagen.make_taxonomy(2, 512, 64, seed=0)
    up = tax.lifting_table()
    if which == "chain":
        assert up.shape[0] >= 12
    rng = np.random.default_rng(4)
    u, v = (rng.integers(0, tax.num_taxa + 1, size=3000).astype(np.int32)
            for _ in range(2))
    u[:5], v[:5] = (0, 0, 1, 7, tax.num_taxa), (0, 9, 0, 7, 1)
    got = lca_pairs_plain(*(torch.from_numpy(a) for a in
                            (u, v, tax.parent, tax.depth, up)))
    want = lca_pairs_jnp(*(jnp.asarray(a) for a in
                           (u, v, tax.parent, tax.depth, up)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), tax.lca_pairs_np(u, v))


@pytest.fixture(scope="module")
def std_cli_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("std_cli")
    bw = make_bench_world(n_reads=150, read_len=120, genome_len=1500, k=21,
                          w=1, tree=(512, 64))
    bw.index.save(str(d / "idx"))
    write_fastq_pair(bw.reads, str(d / "a_1.fastq"), str(d / "a_2.fastq"))
    return d


@pytest.mark.parametrize("thr", ["0.0", "0.05"])
def test_cli_on_std_index_byte_identical_to_jax(std_cli_data, tmp_path,
                                                monkeypatch, thr):
    d = std_cli_data
    monkeypatch.setenv("PANGEA_NO_NATIVE", "1")  # the reference's general path
    args = ["classify", "--index", str(d / "idx"),
            "--reads", str(d / "a_1.fastq"), "--mates", str(d / "a_2.fastq"),
            "--samples", "s", "input.batch_size=64",
            "input.max_read_len=120", "mesh.n_data=1", "mesh.n_shard=1",
            f"classify.confidence_threshold={thr}"]
    ref_out, out = tmp_path / "ref", tmp_path / "port"
    assert ref_cli.main(args + ["--out", str(ref_out)]) == 0
    assert cli.main(args + ["--out", str(out), "--device", "cpu"]) == 0
    names = sorted(f for f in os.listdir(ref_out)
                   if f.endswith(".tsv") or f == "stats.json")
    assert names == ["s.assign.tsv", "s.summary.tsv", "stats.json"]
    for f in names:
        assert (out / f).read_bytes() == (ref_out / f).read_bytes(), f
