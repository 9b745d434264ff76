"""The port's golden model and the host pieces it reads (the taxonomy's
walks, ``Index.lookup_np``, ``revcomp_codes``, the disjoint query
minimizers) and the report statistics ``rarefaction`` and ``bray_curtis``,
against the JAX package's on the same inputs (CPU). Exact equality
throughout, but for the float statistics, held to 1e-12."""
import numpy as np
import pytest

import pangea_tpu.core as ref_core
import pangea_tpu.report.stats as ref_stats
from pangea_tpu.golden import GoldenResult as RefResult
from pangea_tpu.golden import (classify_read_golden as ref_read,
                               classify_reads_golden as ref_reads,
                               merge_multik_golden as ref_merge)
from pangea_tpu.index import build_index as ref_build_index
from pangea_tpu.taxonomy import Taxonomy as RefTaxonomy
from pangea_tpu.utils import datagen as ref_datagen
from pangea_tpu_torch import core
from pangea_tpu_torch.golden import (GoldenResult, classify_read_golden,
                                     classify_reads_golden,
                                     merge_multik_golden)
from pangea_tpu_torch.index import build_index
from pangea_tpu_torch.report import stats
from pangea_tpu_torch.taxonomy import Taxonomy
from pangea_tpu_torch.utils import datagen

# The worlds' (k, w): the q8 headline's, a std (w = 1) world and the q12
# family's k = 31.
WORLDS = {"q8_k21_w8": (21, 8), "std_k21_w1": (21, 1), "q12_k31_w1": (31, 1)}


def _fields(results):
    return [(r.taxon, r.best, r.nvalid) for r in results]


@pytest.fixture(scope="module")
def world():
    """One taxonomy and genomes, the same in both packages; reads with
    N's, pairs, and a genome slice of 1 kb."""
    tax = datagen.make_taxonomy(n_phyla=2, genera_per_phylum=3,
                                species_per_genus=3, seed=7)
    genomes = datagen.make_genomes(tax, genome_len=3000, seed=8)
    ref_tax = ref_datagen.make_taxonomy(n_phyla=2, genera_per_phylum=3,
                                        species_per_genus=3, seed=7)
    ref_genomes = ref_datagen.make_genomes(ref_tax, genome_len=3000, seed=8)
    rs = datagen.sample_reads(genomes, 60, read_len=120, n_prob=0.02,
                              paired=True, seed=9)
    return tax, genomes, ref_tax, ref_genomes, rs


@pytest.fixture(scope="module")
def indexes(world):
    tax, genomes, ref_tax, ref_genomes, _ = world
    return {name: (build_index(genomes, tax, k=k, w=w),
                   ref_build_index(ref_genomes, ref_tax, k=k, w=w))
            for name, (k, w) in WORLDS.items()}


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("name", list(WORLDS))
@pytest.mark.parametrize("thr", [0.0, 0.3])
def test_golden_equals_reference(world, indexes, name, paired, thr):
    rs = world[4]
    idx, ref_idx = indexes[name]
    mates = rs.mates if paired else None
    got = classify_reads_golden(rs.seqs, idx, thr, mates=mates)
    want = ref_reads(rs.seqs, ref_idx, thr, mates=mates)
    assert _fields(got) == _fields(want)
    assert any(r.taxon for r in got)
    assert [r.conf for r in got] == [r.conf for r in want]


@pytest.mark.parametrize("name", list(WORLDS))
def test_golden_long_and_short_reads_equal_reference(world, indexes, name):
    """A 1 kb genome slice, reads shorter than k and shorter than w
    windows, an all-N read."""
    genomes = world[1]
    idx, ref_idx = indexes[name]
    reads = [np.asarray(genomes[0][0][:1000], np.uint8),
             np.asarray(genomes[1][0][:20], np.uint8),
             np.asarray(genomes[2][0][:35], np.uint8),
             np.full(80, 4, np.uint8)]
    for r in reads:
        got, want = classify_read_golden(r, idx, 0.0), ref_read(r, ref_idx,
                                                                 0.0)
        assert (got.taxon, got.best, got.nvalid) == (want.taxon, want.best,
                                                     want.nvalid)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_merge_multik_golden_equals_reference(world, indexes, paired):
    """The k = 21 w = 8 and k = 31 w = 1 calls merged read by read, both
    orders, and the extreme cases of the merge's rules."""
    tax, ref_tax, rs = world[0], world[2], world[4]
    mates = rs.mates if paired else None
    a, ra = indexes["q8_k21_w8"]
    b, rb = indexes["q12_k31_w1"]
    ga, gb = (classify_reads_golden(rs.seqs, ix, 0.0, mates=mates)
              for ix in (a, b))
    wa, wb = (ref_reads(rs.seqs, ix, 0.0, mates=mates) for ix in (ra, rb))
    for x, y, rx, ry in ((ga, gb, wa, wb), (gb, ga, wb, wa)):
        got = [merge_multik_golden(p, q, tax) for p, q in zip(x, y)]
        want = [ref_merge(p, q, ref_tax) for p, q in zip(rx, ry)]
        assert _fields(got) == _fields(want)
    cases = [((0, 0, 5), (0, 0, 7)), ((0, 0, 5), (4, 3, 7)),
             ((4, 3, 7), (0, 0, 5)), ((4, 3, 6), (4, 2, 4)),
             ((4, 2, 4), (4, 3, 6)), ((4, 3, 6), (9, 2, 4)),
             ((9, 2, 4), (4, 3, 6)), ((5, 2**30, 2**30), (6, 2**30 - 1,
                                                           2**30 - 1))]
    for p, q in cases:
        got = merge_multik_golden(GoldenResult(*p), GoldenResult(*q), tax)
        want = ref_merge(RefResult(*p), RefResult(*q), ref_tax)
        assert (got.taxon, got.best, got.nvalid) == (want.taxon, want.best,
                                                     want.nvalid)


def _taxonomies():
    ports = {"bench": datagen.make_taxonomy(seed=1),
             "wide": datagen.make_taxonomy(2, 8, 5, seed=3)}
    refs = {"bench": ref_datagen.make_taxonomy(seed=1),
            "wide": ref_datagen.make_taxonomy(2, 8, 5, seed=3)}
    depth = 40                          # a chain: root -> ... -> leaf
    parent = np.arange(depth + 1, dtype=np.int32) - 1
    parent[:2] = (0, 1)
    rank = np.zeros(depth + 1, np.int8)
    rank[1], rank[-1] = 1, 8
    names = ["unclassified"] + [f"n{i}" for i in range(1, depth + 1)]
    ports["chain"] = Taxonomy.from_tables(parent, rank, names)
    refs["chain"] = RefTaxonomy.from_tables(parent, rank, names)
    return ports, refs


@pytest.mark.parametrize("name", ["bench", "wide", "chain"])
def test_taxonomy_methods_equal_reference(name):
    ports, refs = _taxonomies()
    tax, ref = ports[name], refs[name]
    for field in ("parent", "rank", "depth", "tin", "tout"):
        np.testing.assert_array_equal(getattr(tax, field),
                                      getattr(ref, field))
    assert tax.names == ref.names
    T1 = tax.num_taxa + 1
    a, t = np.meshgrid(np.arange(T1), np.arange(T1), indexing="ij")
    np.testing.assert_array_equal(tax.is_ancestor_or_self(a, t),
                                  ref.is_ancestor_or_self(a, t))
    assert tax.is_ancestor_or_self(1, T1 - 1) == \
        ref.is_ancestor_or_self(1, T1 - 1)
    rng = np.random.default_rng(T1)
    pairs = [(int(x), int(y)) for x, y in rng.integers(0, T1, (300, 2))]
    pairs += [(0, 0), (0, T1 - 1), (T1 - 1, 0), (1, T1 - 1), (T1 - 1,
                                                             T1 - 1)]
    assert [tax.lca(x, y) for x, y in pairs] == [ref.lca(x, y)
                                                 for x, y in pairs]
    for n in (0, 1, 2, 5, T1):
        group = rng.integers(0, T1, n)
        assert tax.lca_many(group) == ref.lca_many(group)
    for t in range(1, T1):
        assert tax.ancestors(t) == ref.ancestors(t)
    assert [tax.rank_name(t) for t in range(T1)] == [ref.rank_name(t)
                                                     for t in range(T1)]


@pytest.mark.parametrize("stash", [False, True],
                         ids=["default", "overflow"])
@pytest.mark.parametrize("k", [21, 31])
def test_index_lookup_np_equals_reference(world, k, stash):
    """Every stored k-mer, absent ones and invalid positions; the default
    table and one forced to overflow into its stash (4 ways at load
    factor 0.95)."""
    tax, genomes, ref_tax, ref_genomes, _ = world
    kw = {"ways": 4, "load_factor": 0.95} if stash else {}
    idx = build_index(genomes, tax, k=k, **kw)
    ref = ref_build_index(ref_genomes, ref_tax, k=k, **kw)
    assert idx.stash.shape[1] > (8 if stash else -1)
    stored = idx.key_hi.astype(np.uint64) << np.uint64(32) \
        | idx.key_lo.astype(np.uint64)
    stored = stored[idx.key_hi != 0xFFFFFFFF]
    if stash:
        stored = np.concatenate([stored, idx.stash[0].astype(np.uint64)
                                 << np.uint64(32)
                                 | idx.stash[1].astype(np.uint64)])
    rng = np.random.default_rng(k)
    absent = rng.integers(0, 1 << (2 * k), 500, dtype=np.uint64)
    canon = np.concatenate([stored, absent])
    valid = rng.random(canon.size) < 0.9
    got = idx.lookup_np(canon, valid)
    np.testing.assert_array_equal(got, ref.lookup_np(canon, valid))
    assert got.dtype == np.int32 and (got[:stored.size][
        valid[:stored.size]] != 0).all()


def test_revcomp_and_disjoint_minimizers_equal_reference():
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 150, 1000):
        codes = rng.integers(0, 5, n).astype(np.uint8)
        np.testing.assert_array_equal(core.revcomp_codes(codes),
                                      ref_core.revcomp_codes(codes))
        for k in (5, 21, 31):
            canon, valid = core.canonical_kmers(codes, k)
            for w in (2, 3, 8, 32):
                got = core.disjoint_query_minimizers(canon, valid, w)
                want = ref_core.disjoint_query_minimizers(canon, valid, w)
                for a, b in zip(got, want):
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        core.disjoint_query_minimizers(np.zeros(4, np.uint64),
                                       np.ones(4, bool), 1)


@pytest.mark.parametrize("counts", [
    [], [0, 0, 0], [1], [5, 0, 3, 1, 1, 2], [1] * 40,
    list(np.random.default_rng(0).integers(0, 50, 200)), [10**6, 1, 2]],
    ids=["empty", "zeros", "single", "small", "singletons", "random",
         "skewed"])
def test_rarefaction_and_bray_curtis_equal_reference(counts):
    """Depth 0, negative, 1, past n and n itself; all-zero and empty
    vectors."""
    n = int(np.sum(counts)) if len(counts) else 0
    depths = [0, -3, 1, 2, max(n // 2, 1), n, n + 1, 10 * n + 5]
    got = stats.rarefaction(counts, depths)
    want = ref_stats.rarefaction(counts, depths)
    assert [d for d, _ in got] == [d for d, _ in want]
    np.testing.assert_allclose([e for _, e in got], [e for _, e in want],
                               rtol=1e-12, atol=1e-12)
    rng = np.random.default_rng(len(counts))
    other = rng.integers(0, 5, len(counts))
    for a, b in ((counts, other), (other, counts), (counts, counts),
                 ([0] * len(counts), [0] * len(counts))):
        assert abs(stats.bray_curtis(a, b) - ref_stats.bray_curtis(a, b)) \
            <= 1e-12
