"""The port's bench world against the reference bench's world (CPU)."""
import dataclasses

import numpy as np
import pytest

from pangea_tpu.bench import make_bench_world as ref_make_bench_world
from pangea_tpu.golden import classify_reads_golden
from pangea_tpu.index import build_index
from pangea_tpu.utils import datagen
from pangea_tpu_torch.bench import (make_bench_world, make_deep_world,
                                    write_fastq_pair)

SMALL = dict(read_len=100, n_species=12, genome_len=3000, k=21)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("PANGEA_BENCH_CACHE", str(tmp_path_factory.mktemp("cache")))
    try:
        ref = ref_make_bench_world(n_reads=60, paired=True, **SMALL)
    finally:
        mp.undo()
    return ref, make_bench_world(n_reads=40, w=8, **SMALL)


def test_reads_are_a_prefix_of_the_reference_bench(worlds):
    (tax, genomes, _, rs), bw = worlds
    assert bw.taxonomy.content_hash() == tax.content_hash()
    assert bw.reads.ids == rs.ids[:40]
    np.testing.assert_array_equal(bw.reads.truth, rs.truth[:40])
    for got, want in ((bw.reads.seqs, rs.seqs), (bw.reads.mates, rs.mates)):
        assert len(got) == 40
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_index_is_built_at_the_window(worlds):
    (tax, genomes, _, rs), bw = worlds
    want = build_index(genomes, tax, k=21, w=8, ways=0)
    assert dataclasses.asdict(bw.index.meta) == dataclasses.asdict(want.meta)
    for name in ("key_hi", "key_lo", "val", "stash"):
        np.testing.assert_array_equal(getattr(bw.index, name),
                                      getattr(want, name))
    gold = classify_reads_golden(bw.reads.seqs, want, 0.0,
                                 mates=bw.reads.mates)
    assert sum(g.taxon != 0 for g in gold) > 30


def test_write_fastq_pair(worlds, tmp_path):
    bw = worlds[1]
    p1, p2 = tmp_path / "r_1.fq", tmp_path / "r_2.fq"
    write_fastq_pair(bw.reads, str(p1), str(p2))
    l1, l2 = p1.read_text().splitlines(), p2.read_text().splitlines()
    assert len(l1) == len(l2) == 4 * 40
    assert l1[0] == l2[0] == "@" + bw.reads.ids[0]
    assert l1[1] == "".join("ACGTN"[c] for c in bw.reads.seqs[0])
    assert l2[1] == "".join("ACGTN"[c] for c in bw.reads.mates[0])


def test_deep_world_is_the_reference_bench_deep_cell():
    """The deep cell as the reference bench builds it inline
    (``run_bench_extras``): the tree, the first 24 genomes, the single-end
    reads and the k=21, w=1 index, at a small genome length."""
    dw = make_deep_world(n_reads=50, read_len=100, genome_len=3000)
    tax = datagen.make_taxonomy(n_phyla=2, genera_per_phylum=8,
                                species_per_genus=3, seed=31)
    genomes = datagen.make_genomes(tax, genome_len=3000, seed=32)[:24]
    rs = datagen.sample_reads(genomes, 50, read_len=100, paired=False,
                              n_prob=0.005, seed=33)
    assert dw.taxonomy.content_hash() == tax.content_hash()
    assert len(dw.genomes) == 24 and dw.reads.mates is None
    for (a, ta), (b, tb) in zip(dw.genomes, genomes):
        assert ta == tb
        np.testing.assert_array_equal(a, b)
    assert dw.reads.ids == rs.ids
    for a, b in zip(dw.reads.seqs, rs.seqs):
        np.testing.assert_array_equal(a, b)
    want = build_index(genomes, tax, k=21, w=1)
    assert dataclasses.asdict(dw.index.meta) == dataclasses.asdict(want.meta)
    for name in ("key_hi", "key_lo", "val", "stash"):
        np.testing.assert_array_equal(getattr(dw.index, name),
                                      getattr(want, name))
