"""The port's long-read path against the JAX package (CPU): the ranked
pscore (B11) and the general path's length buckets.

Exact equality throughout: every output is an integer. The two pscore forms
agree where every hit's t_in < t_out, so the intervals come from a real
taxonomy's Euler stamps.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu import cli as ref_cli
from pangea_tpu.golden import classify_read_golden
from pangea_tpu.kernels.score import (_pscore_quad_chunked, _pscore_ranked,
                                      score_reads_jnp, score_reads_tin_jnp)
from pangea_tpu.utils import datagen as ref_datagen
from pangea_tpu_torch import cli
from pangea_tpu_torch.kernels import (pscore_ranked_plain,
                                      score_reads_taxon_plain,
                                      score_reads_tin_plain)
from pangea_tpu_torch.kernels.score import MAX_PROBES
from pangea_tpu_torch.pipeline.run import bucket_batch

from .helpers import small_world


def _lineage_lanes(tax, B, R, seed):
    """[B, R] hit taxa drawn from four taxa a read (so reads have real
    winners), about half of them misses, and their Euler intervals."""
    rng = np.random.default_rng(seed)
    lineage = rng.integers(1, tax.num_taxa + 1, size=(B, 4))
    taxa = lineage[np.arange(B)[:, None], rng.integers(0, 4, size=(B, R))]
    taxon = np.where(rng.random((B, R)) < 0.5, taxa, 0).astype(np.int32)
    taxon[0] = 0                                     # a read with no hit
    t_in = np.where(taxon != 0, tax.tin[taxon], 0).astype(np.int32)
    t_out = np.where(taxon != 0, tax.tout[taxon], 0).astype(np.int32)
    valid = (rng.random((B, R)) < 0.8) | (taxon != 0)
    valid[1] = False                                 # nvalid = 0
    return taxon, t_in, t_out, valid


@pytest.mark.parametrize("R", [2049, 4096, 5000])
def test_pscore_ranked_plain_matches_reference_forms(R):
    tax = ref_datagen.make_taxonomy(2, 8, 3, seed=0)
    taxon, t_in, t_out, _ = _lineage_lanes(tax, 3, R, seed=R)
    hit = taxon != 0
    got = pscore_ranked_plain(torch.from_numpy(t_in), torch.from_numpy(t_out),
                              torch.from_numpy(hit)).numpy()
    args = (jnp.asarray(t_in), jnp.asarray(t_out), jnp.asarray(hit))
    ranked = np.asarray(_pscore_ranked(*args))
    quad = np.asarray(_pscore_quad_chunked(*args, max_elems=R * R))
    np.testing.assert_array_equal(got, ranked)
    np.testing.assert_array_equal(got[hit], quad[hit])
    assert got[hit].max() > 1


def _tax_arrays(tax):
    return {k: torch.from_numpy(v) for k, v in tax.device_arrays().items()}


@pytest.mark.parametrize("thr", [0.0, 0.05])
@pytest.mark.parametrize("tree", [(8, 3), (64, 40)], ids=["direct",
                                                          "lifting"])
@pytest.mark.parametrize("form", ["q8", "taxon"])
def test_score_past_max_probes_matches_reference_ranked(monkeypatch, form,
                                                        tree, thr):
    """R = 2,100 > MAX_PROBES: the plain scorers (the ranked pscore) equal
    the reference's under its own PANGEA_PSCORE=rank switch, with the
    direct LCA (67 taxa) and binary lifting (5,251 taxa)."""
    monkeypatch.setenv("PANGEA_PSCORE", "rank")
    tax = ref_datagen.make_taxonomy(2, *tree, seed=0)
    R = 2100
    assert R > MAX_PROBES
    taxon, t_in, t_out, valid = _lineage_lanes(tax, 6, R, seed=len(form))
    lanes = taxon if form == "taxon" else (taxon != 0).astype(np.int32)
    plain = score_reads_taxon_plain if form == "taxon" else \
        score_reads_tin_plain
    got = plain(*(torch.from_numpy(a) for a in (lanes, t_in, t_out, valid)),
                _tax_arrays(tax), thr)
    ref = score_reads_jnp if form == "taxon" else score_reads_tin_jnp
    tax_j = {k: jnp.asarray(v) for k, v in tax.device_arrays().items()}
    want = ref((jnp.asarray(lanes), jnp.asarray(t_in), jnp.asarray(t_out)),
               jnp.asarray(valid.sum(1, dtype=np.int32)), tax_j, thr)
    for g, key in zip(got, ("taxon", "best", "nvalid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[key]))
    assert (got[0] != 0).any()


LONG_LENS = (1200, 2500, 5000)       # buckets 1200, 4800 and 9600 at L=150


@pytest.fixture(scope="module")
def longworld(tmp_path_factory):
    """A k=21, w=1 index on 6 kb genomes and one FASTQ of 60 short reads
    and nine genome slices of 1.2, 2.5 and 5 kb."""
    d = tmp_path_factory.mktemp("torch_long")
    tax, genomes, idx, rs = small_world(k=21, seed=3, genome_len=6000,
                                        n_reads=60, read_len=120, w=1)
    idx.save(str(d / "idx"))
    rng = np.random.default_rng(5)
    longs = []
    for n in LONG_LENS * 3:
        codes, _ = genomes[rng.integers(0, len(genomes))]
        s = rng.integers(0, len(codes) - n)
        longs.append(np.asarray(codes[s:s + n], dtype=np.uint8))
    reads = ref_datagen.ReadSet(
        ids=list(rs.ids) + [f"long{i}" for i in range(len(longs))],
        seqs=list(rs.seqs) + longs, mates=None,
        truth=np.zeros(len(rs.seqs) + len(longs), np.int32))
    ref_datagen.write_fastq(str(d / "mix.fastq"), reads, mate=1)
    return d, idx, reads


def _both_clis(d, tmp_path, extra):
    args = ["classify", "--index", str(d / "idx"), "--reads",
            str(d / "mix.fastq"), "--samples", "s", "input.batch_size=32",
            "input.max_read_len=150", "input.long_reads=true",
            "mesh.n_data=1", "mesh.n_shard=1", *extra]
    ref_out, out = tmp_path / "ref", tmp_path / "port"
    assert ref_cli.main(args + ["--out", str(ref_out)]) == 0
    assert cli.main(args + ["--out", str(out), "--device", "cpu"]) == 0
    return ref_out, out


def test_long_read_cli_byte_identical_to_jax_and_golden(longworld, tmp_path,
                                                        capsys):
    d, idx, reads = longworld
    ref_out, out = _both_clis(d, tmp_path, [])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["fast_path"] is False and result["truncated_reads"] == 0
    assert result["kernel_launches"]["score_ranked"] == 0     # CPU: plain
    for f in ("s.assign.tsv", "s.summary.tsv", "stats.json"):
        assert (out / f).read_bytes() == (ref_out / f).read_bytes(), f
    lines = {r[1]: r for r in (line.split("\t") for line in
                               (out / "s.assign.tsv").read_text()
                               .splitlines())}
    for rid, seq in zip(reads.ids, reads.seqs):
        if rid.startswith("long"):
            g = classify_read_golden(seq, idx, 0.0)
            assert (int(lines[rid][2]), lines[rid][5]) == \
                (g.taxon, f"{g.best}/{g.nvalid}"), rid
            assert g.taxon != 0


def test_long_read_cap_counts_truncated_reads_as_jax(longworld, tmp_path,
                                                     capsys):
    d, _, reads = longworld
    ref_out, out = _both_clis(d, tmp_path, ["input.max_long_read_len=600"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = json.load(open(ref_out / "run_summary.json"))["truncated_reads"]
    assert result["truncated_reads"] == want == len(LONG_LENS) * 3
    assert (out / "s.assign.tsv").read_bytes() == \
        (ref_out / "s.assign.tsv").read_bytes()


def test_bucket_batch_shapes_follow_the_reference_rule():
    """Reads of at most L bases in one launch; each longer read in the
    bucket L * 2^j, capped, max(64, B * L // Lj) reads a launch, every read
    exactly once; the mates' longer length decides."""
    rng = np.random.default_rng(0)
    lens = [100, 150, 151, 300, 301, 2000, 2500, 9000, 20000] * 20
    seqs = [rng.integers(0, 4, size=n).astype(np.uint8) for n in lens]
    mates = [s[:50] for s in seqs]
    mates[0] = rng.integers(0, 4, size=400).astype(np.uint8)   # 100 -> 600
    launches, cut = bucket_batch(seqs, mates, 1024, 150, 16384)
    assert cut == 20
    seen = np.concatenate([sub for sub, _, _ in launches])
    assert sorted(seen.tolist()) == list(range(len(seqs)))
    for sub, bases, mb in launches:
        Lj = bases.shape[1]
        assert bases.shape == mb.shape == (sub.size, Lj)
        assert sub.size <= max(64, 1024 * 150 // Lj)
        for i in sub:
            n = max(len(seqs[i]), len(mates[i]))
            want = 150 if n <= 150 else min(
                150 * 2 ** int(np.ceil(np.log2(n / 150))), 16384)
            assert Lj == want, (i, n, Lj)
    assert {b.shape[1] for _, b, _ in launches} == {
        150, 300, 600, 2400, 4800, 9600, 16384}
