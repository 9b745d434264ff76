"""The port's numpy copies of the reference's host code, against the
reference on the same inputs (CPU). Exact equality throughout: the copies
must give the same bytes, hashes and lines."""
import dataclasses
import gzip
import json
from pathlib import Path

import numpy as np
import pytest

import pangea_tpu.config as ref_config
import pangea_tpu.core as ref_core
import pangea_tpu.index as ref_index
import pangea_tpu.io.fastx as ref_fastx
import pangea_tpu.report.stats as ref_stats
import pangea_tpu.report.writers as ref_writers
import pangea_tpu.utils.datagen as ref_datagen
from pangea_tpu.index.build import pick_layout as ref_pick_layout
from pangea_tpu.taxonomy import Taxonomy as RefTaxonomy
from pangea_tpu_torch import config, core, index
from pangea_tpu_torch.index.build import pick_layout
from pangea_tpu_torch.io import fastx
from pangea_tpu_torch.report import stats, writers
from pangea_tpu_torch.taxonomy import Taxonomy
from pangea_tpu_torch.utils import datagen

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data"
INDEX_ARRAYS = ("key_hi", "key_lo", "val", "stash")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _world(mod, k, w, tree=(2, 3)):
    tax = mod.make_taxonomy(n_phyla=2, genera_per_phylum=tree[0],
                            species_per_genus=tree[1], seed=0)
    genomes = mod.make_genomes(tax, genome_len=2500, seed=1)
    rs = mod.sample_reads(genomes, 30, read_len=120, paired=True, seed=2)
    return tax, genomes, rs


def test_semantics_equal():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, size=700).astype(np.uint8)
    for k in (3, 21, 31):
        got, want = (m.canonical_kmers(codes, k) for m in (core, ref_core))
        for a, b in zip(got, want):
            _same(a, b)
        for w in (1, 4, 8):
            _same(core.minimizer_mask(*got, w), ref_core.minimizer_mask(
                *want, w))
    keys = rng.integers(0, 1 << 62, size=1000, dtype=np.uint64)
    _same(core.hash32_np(keys), ref_core.hash32_np(keys))


@pytest.mark.parametrize("k,w,ways", [(21, 1, 16), (21, 8, 16), (31, 8, 16),
                                      (21, 1, 0)],
                         ids=["k21w1", "k21w8", "k31w8", "k21w1_auto"])
def test_build_index_byte_equal(k, w, ways):
    tax, genomes, _ = _world(datagen, k, w)
    ref_tax, ref_genomes, _ = _world(ref_datagen, k, w)
    got = index.build_index(genomes, tax, k=k, w=w, ways=ways)
    want = ref_index.build_index(ref_genomes, ref_tax, k=k, w=w, ways=ways)
    assert dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta)
    for name in INDEX_ARRAYS:
        _same(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_index_saved_by_one_loads_in_the_other(tmp_path, direction):
    tax, genomes, _ = _world(datagen, 21, 8)
    idx = index.build_index(genomes, tax, k=21, w=8)
    ref_tax, ref_genomes, _ = _world(ref_datagen, 21, 8)
    ref = ref_index.build_index(ref_genomes, ref_tax, k=21, w=8)
    src, load = ((idx, ref_index.load_index_any)
                 if direction == "port_to_ref"
                 else (ref, index.load_index_any))
    src.save(str(tmp_path / "idx"))
    back = load(str(tmp_path / "idx"))
    assert dataclasses.asdict(back.meta) == dataclasses.asdict(src.meta)
    for name in INDEX_ARRAYS:
        _same(getattr(back, name), getattr(src, name))
    assert back.taxonomy.content_hash() == src.taxonomy.content_hash()


def test_sharded_index_directory_raises(tmp_path):
    """A sharded directory (it raised before the port ran sharded indexes)
    loads as a ShardedIndex equal to the reference's load of it, and a
    directory whose meta.json lacks the taxonomy still raises."""
    tax = ref_datagen.make_taxonomy(seed=0)
    genomes = ref_datagen.make_genomes(tax, genome_len=2000, seed=1)
    ref_index.build_index_ooc(genomes, tax, k=21, out=str(tmp_path / "idx"),
                              n_shards=4, parts_per_shard=2)
    want = ref_index.load_index_any(str(tmp_path / "idx"))
    got = index.load_index_any(str(tmp_path / "idx"))
    assert isinstance(got, index.ShardedIndex)
    assert dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta)
    assert got.nbytes == want.nbytes and len(got.shards) == 4
    for a, b in zip(got.shards, want.shards):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert got.taxonomy.content_hash() == want.taxonomy.content_hash()
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "meta.json").write_text(json.dumps({"sharded": True}))
    with pytest.raises(TypeError):
        index.load_index_any(str(tmp_path / "bad"))


def _tsv(tmp_path):
    tax = ref_datagen.make_taxonomy(2, 3, 4, seed=0)
    path = tmp_path / "tax.tsv"
    ref_datagen.write_taxonomy_tsv(str(path), tax)
    return path


@pytest.mark.parametrize("source", ["datagen", "big_tree", "chain", "tsv",
                                    "ncbi", "npz"])
def test_taxonomy_equal(tmp_path, source):
    if source in ("datagen", "big_tree"):
        shape = (2, 3) if source == "datagen" else (64, 40)
        got = datagen.make_taxonomy(2, *shape, seed=0)
        want = ref_datagen.make_taxonomy(2, *shape, seed=0)
    elif source == "chain":
        parent = np.arange(-1, 300, dtype=np.int32)
        parent[:2] = (0, 1)
        rank = np.zeros(301, np.int8)
        names = ["unclassified"] + [f"n{i}" for i in range(1, 301)]
        got = Taxonomy(parent=parent, rank=rank, names=names)
        want = RefTaxonomy(parent=parent, rank=rank, names=names)
    elif source == "tsv":
        path = str(_tsv(tmp_path))
        got, want = Taxonomy.load_tsv(path), RefTaxonomy.load_tsv(path)
    elif source == "ncbi":
        args = (str(DATA / "nodes.dmp"), str(DATA / "names.dmp"))
        got, want = Taxonomy.load_ncbi(*args), RefTaxonomy.load_ncbi(*args)
        _same(got.raw_ids, want.raw_ids)
        assert got.raw_to_dense == want.raw_to_dense
    else:
        src = ref_datagen.make_taxonomy(2, 3, 4, seed=0)
        src.save(str(tmp_path / "t.npz"))
        got = Taxonomy.load(str(tmp_path / "t.npz"))
        want = RefTaxonomy.load(str(tmp_path / "t.npz"))
    for name in ("parent", "rank", "depth", "tin", "tout"):
        _same(getattr(got, name), getattr(want, name))
    assert got.names == want.names
    ga, wa = got.device_arrays(), want.device_arrays()
    assert sorted(ga) == sorted(wa)
    for name in wa:
        _same(ga[name], wa[name])
    assert got.content_hash() == want.content_hash()
    rng = np.random.default_rng(1)
    u, v = (rng.integers(0, got.num_taxa + 1, size=500) for _ in range(2))
    _same(got.lca_pairs_np(u, v), want.lca_pairs_np(u, v))


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT))
                   for p in (ROOT / "configs").glob("*.json")))
def test_load_config_equal(tmp_path, path):
    overrides = ["input.batch_size=64", "classify.confidence_threshold=0.1",
                 'demux.barcodes=[["s", "ACGT"]]', "classify.out_dir=x"]
    got = config.load_config(str(ROOT / path), overrides)
    want = ref_config.load_config(str(ROOT / path), overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    config.dump_config(got, str(tmp_path / "a.json"))
    ref_config.dump_config(want, str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    with pytest.raises(ValueError, match="unknown config key"):
        config.load_config(str(ROOT / path), ["input.nope=1"])


@pytest.mark.parametrize("kind", ["paired", "single_gz", "fasta"])
def test_read_batches_equal(tmp_path, kind):
    _, genomes, rs = _world(ref_datagen, 21, 1)
    mate = None
    if kind == "fasta":
        path = tmp_path / "g.fasta"
        ref_datagen.write_fasta(str(path), genomes,
                                ref_datagen.make_taxonomy(2, 2, 3, seed=0))
    else:
        path = tmp_path / "r_1.fastq"
        ref_datagen.write_fastq(str(path), rs, mate=1)
        if kind == "paired":
            mate = str(tmp_path / "r_2.fastq")
            ref_datagen.write_fastq(mate, rs, mate=2)
        else:
            gz = tmp_path / "r.fastq.gz"
            gz.write_bytes(gzip.compress(path.read_bytes()))
            path = gz
    got = list(fastx.read_batches(str(path), 7, mate_path=mate, sample="s"))
    want = list(ref_fastx.read_batches(str(path), 7, mate_path=mate,
                                       sample="s"))
    assert len(got) == len(want) > 1
    for g, x in zip(got, want):
        assert g.ids == x.ids and g.sample == x.sample
        for name in ("seqs", "quals", "mate_seqs", "mate_quals"):
            a, b = getattr(g, name), getattr(x, name)
            assert (a is None) == (b is None)
            for ai, bi in zip(a or [], b or []):
                _same(ai, bi)


def test_writers_and_stats_equal(tmp_path):
    tax = datagen.make_taxonomy(2, 3, 4, seed=0)
    ref_tax = ref_datagen.make_taxonomy(2, 3, 4, seed=0)
    rng = np.random.default_rng(3)
    taxa = rng.integers(0, tax.num_taxa + 1, size=200)
    best = rng.integers(0, 50, size=200)
    nvalid = best + rng.integers(0, 50, size=200)
    nvalid[:3] = 0
    for t, b, n in zip(taxa, best, nvalid):
        args = (f"r{t}", int(t), int(b), int(n))
        assert writers.format_assignment(writers.AssignmentRecord(*args),
                                         tax) == \
            ref_writers.format_assignment(
                ref_writers.AssignmentRecord(*args), ref_tax)
    # The port writes its summaries from per-taxon counts; the reference's
    # general path from the taxa themselves.
    direct = np.bincount(taxa, minlength=tax.num_taxa + 1)
    writers.write_summary_counts(str(tmp_path / "a.tsv"), direct, tax)
    ref_writers.write_summary(str(tmp_path / "b.tsv"), taxa, ref_tax)
    samples = {"s2": taxa[:80], "s1": taxa[80:]}
    writers.write_cohort_summary_counts(
        str(tmp_path / "c.tsv"),
        {n: np.bincount(t, minlength=tax.num_taxa + 1)
         for n, t in samples.items()}, tax)
    ref_writers.write_cohort_summary(str(tmp_path / "d.tsv"), samples,
                                     ref_tax)
    for a, b in (("a", "b"), ("c", "d")):
        assert (tmp_path / f"{a}.tsv").read_bytes() == \
            (tmp_path / f"{b}.tsv").read_bytes()
    for g, w in zip(writers.summarize_counts(direct, tax),
                    ref_writers.summarize(taxa, ref_tax)):
        _same(g, w)
    for counts in (np.bincount(taxa)[1:], np.array([1, 1, 2, 5, 0, 12, 1]),
                   np.zeros(4, np.int64), np.arange(30)):
        assert stats.sample_stats(counts) == ref_stats.sample_stats(counts)


def test_datagen_equal(tmp_path):
    tax, genomes, rs = _world(datagen, 21, 1, tree=(3, 4))
    ref_tax, ref_genomes, ref_rs = _world(ref_datagen, 21, 1, tree=(3, 4))
    assert tax.species_ids == ref_tax.species_ids
    assert [t for _, t in genomes] == [t for _, t in ref_genomes]
    for (a, _), (b, _) in zip(genomes, ref_genomes):
        _same(a, b)
    assert rs.ids == ref_rs.ids
    _same(rs.truth, ref_rs.truth)
    for a, b in zip(rs.seqs + rs.mates + rs.quals,
                    ref_rs.seqs + ref_rs.mates + ref_rs.quals):
        _same(a, b)
    single = datagen.sample_reads(genomes, 20, read_len=90, seed=5)
    ref_single = ref_datagen.sample_reads(ref_genomes, 20, read_len=90,
                                          seed=5)
    assert single.mates is None and ref_single.mates is None
    for a, b in zip(single.seqs, ref_single.seqs):
        _same(a, b)
    for mate in (1, 2):
        datagen.write_fastq(str(tmp_path / "a.fq"), rs, mate=mate)
        ref_datagen.write_fastq(str(tmp_path / "b.fq"), ref_rs, mate=mate)
        assert (tmp_path / "a.fq").read_bytes() == \
            (tmp_path / "b.fq").read_bytes()
    datagen.write_fasta(str(tmp_path / "a.fa"), genomes, tax)
    ref_datagen.write_fasta(str(tmp_path / "b.fa"), ref_genomes, ref_tax)
    assert (tmp_path / "a.fa").read_bytes() == \
        (tmp_path / "b.fa").read_bytes()


def _layout_or_error(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return f"ValueError: {e}"


def test_pick_layout_equal_over_a_grid():
    for n in (0, 1, 5_000, 444_302, 1_100_000, 2_000_000, 3_000_000,
              30_000_000):
        for k in (15, 21, 23, 25, 27, 29, 31):
            for tout_max in (100, 0xFFFF, 0x10000, 66_563):
                for n_shards in (1, 4):
                    for requested in ("auto", "std", "q8", "q12"):
                        args = (n, n_shards, k, tout_max)
                        assert _layout_or_error(
                            pick_layout, *args, requested=requested) == \
                            _layout_or_error(
                                ref_pick_layout, *args,
                                requested=requested), (args, requested)
