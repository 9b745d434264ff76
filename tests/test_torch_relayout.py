"""The index's relayout on the device (``classify/relayout.py``) against the
host's (``classify/engine.py`` ``_host_tables``), byte for byte, on CPU
tensors: the whole placement for the std (packed and wide), q8 and q12
layouts, a stash, a stash overflow that doubles the bucket count, an empty
index and a sharded index laid out whole; the quotient layouts at any
bucket width against ``q8_layout`` / ``q12_layout``."""
import numpy as np
import pytest
import torch

from pangea_tpu_torch import SEMANTICS_VERSION, trace
from pangea_tpu_torch.classify import DeviceIndex, relayout
from pangea_tpu_torch.classify.engine import TAX_KEYS, _host_tables
from pangea_tpu_torch.index import Index, IndexMeta, build_index_ooc
from pangea_tpu_torch.index.build import layout_table
from pangea_tpu_torch.index.quot import (_capacity_nb, q8_layout, q8_nb_for,
                                         q12_layout, q12_nb_for)
from pangea_tpu_torch.index.shard import extract_pairs
from pangea_tpu_torch.kernels import fuse_stash
from pangea_tpu_torch.utils import datagen

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def taxonomies():
    """A small tree, and one past 16-bit Euler stamps (66,563 taxa)."""
    return {False: datagen.make_taxonomy(2, 8, 3),
            True: datagen.make_taxonomy(2, 512, 64)}


def _index(tax, n: int, k: int, ways: int, seed: int = 0) -> Index:
    """An index of about n random k-mers of random taxa, laid out by
    ``layout_table`` at ``ways``."""
    rng = np.random.default_rng(seed)
    kmers = np.unique(rng.integers(0, 1 << (2 * k), size=n, dtype=np.uint64))
    taxa = rng.integers(1, tax.num_taxa + 1, size=kmers.size,
                        dtype=np.int32)
    key_hi, key_lo, val, stash, nb = layout_table(kmers, taxa, ways=ways)
    meta = IndexMeta(k=k, w=1, n_buckets=nb, ways=ways,
                     n_kmers=int(kmers.size), n_stash=int(stash.shape[1]),
                     taxonomy_hash=tax.content_hash(),
                     semantics_version=SEMANTICS_VERSION)
    return Index(meta, key_hi, key_lo, val, tax, stash=stash)


def _same_index(got: DeviceIndex, want: DeviceIndex):
    assert got.cfg == want.cfg
    for a, b in [(got.fused, want.fused), (got.stash, want.stash)] + [
            (got.tax[n], want.tax[n]) for n in TAX_KEYS]:
        assert a.dtype == b.dtype == torch.int32
        assert a.shape == b.shape
        assert a.cpu().numpy().tobytes() == b.numpy().tobytes()


def _both(index, layout):
    """(the index laid out by the device's relayout on CPU tensors, by the
    host's), and the device's placement record."""
    with trace.Placement(CPU) as place:
        got = DeviceIndex._laid_out_on(index, CPU, place, 0.05, layout)
    tables, cfg = _host_tables(index, 0.05, layout, 1, 0, None)
    return got, DeviceIndex.from_numpy_tables(tables, cfg, CPU), \
        place.record()


# name -> (wide taxonomy, k-mers, k, stored ways, layout)
CASES = {"std_packed": (False, 20_000, 21, 16, "std"),
         "std_wide": (True, 20_000, 21, 16, "std"),
         "q8": (False, 20_000, 21, 16, "q8"),
         "q12": (False, 20_000, 31, 16, "q12"),
         "auto": (False, 20_000, 21, 16, None),
         "stash": (False, 10_000, 21, 8, "std"),
         "stash_doubles": (False, 3_000, 21, 2, "std"),
         "empty_std": (False, 0, 21, 16, "std"),
         "empty_q8": (False, 0, 21, 16, "q8")}


@pytest.mark.parametrize("name", list(CASES))
def test_relayout_equals_the_host(taxonomies, name):
    wide, n, k, ways, layout = CASES[name]
    index = _index(taxonomies[wide], n, k, ways)
    got, want, rec = _both(index, layout)
    _same_index(got, want)
    assert rec["layout_on"] == "card"
    assert got.cfg.layout == (layout or "q8")
    if name == "std_wide":
        assert got.fused.shape[1] == 6 * ways
    if name.startswith("stash"):
        assert index.stash.shape[1] > 0, "no stored stash"
        assert (got.stash[0] != -1).any(), "no stash laid out"
    if layout == "std":
        nb = _capacity_nb(index.meta.n_kmers, ways, 0.5)
        assert (got.fused.shape[0] > nb) == (name == "stash_doubles")


@pytest.mark.parametrize("layout,k,ways,doubles", [
    ("q8", 21, 64, False), ("q8", 21, 4, True), ("q8", 27, 4, False),
    ("q12", 31, 42, False), ("q12", 31, 4, True), ("q12", 21, 4, True)])
def test_quot_layout_at_any_width(taxonomies, layout, k, ways, doubles):
    """The pairs extracted on the device equal ``extract_pairs``'; laid out
    at any width (at 4 the stash overflows and the bucket count doubles,
    but at k=27, where the remainder's width has grown the bucket count
    already) they equal ``q8_layout``'s or ``q12_layout``'s rows, stash
    and bucket count."""
    tax = taxonomies[False]
    index = _index(tax, 20_000, k, 8, seed=1)
    canon, taxa = extract_pairs(index)
    d_canon, d_taxa = relayout.extract_pairs(relayout.upload(index, CPU))
    assert d_canon.numpy().tobytes() == canon.astype(np.int64).tobytes()
    assert d_taxa.numpy().tobytes() == taxa.tobytes()
    fn, nb_fn = {"q8": (q8_layout, q8_nb_for),
                 "q12": (q12_layout, q12_nb_for)}[layout]
    fused, stash, nb = fn(canon, taxa, tax.tin, tax.tout, k, ways=ways)
    tin, tout = (torch.from_numpy(a.astype(np.int32))
                 for a in (tax.tin, tax.tout))
    got = relayout.layout_quot(d_canon, d_taxa, tin, tout, k, layout, ways)
    assert got[2] == nb
    assert got[0].numpy().tobytes() == fused.view(np.int32).tobytes()
    assert got[0].shape == fused.shape
    want_stash = fuse_stash(stash, tax.tin, tax.tout)
    assert got[1].shape == want_stash.shape
    assert got[1].numpy().tobytes() == want_stash.tobytes()
    assert (nb > nb_fn(canon.size, k, ways)) == doubles
    wide = taxonomies[True]
    wtin, wtout = (torch.from_numpy(a) for a in (wide.tin, wide.tout))
    assert relayout.layout_quot(d_canon, d_taxa, wtin, wtout, k, layout,
                                ways) is None


@pytest.mark.parametrize("layout", ["std", "q8"])
def test_sharded_index_laid_out_whole(tmp_path_factory, layout):
    """A sharded index placed on one device is laid out whole from every
    file shard, as the host lays it out."""
    tax = datagen.make_taxonomy(2, 4, 3)
    genomes = datagen.make_genomes(tax, genome_len=3000, seed=2)
    d = tmp_path_factory.mktemp("ooc")
    sidx = build_index_ooc(genomes, tax, k=21, out=str(d / "idx"),
                           n_shards=4, parts_per_shard=2)
    got, want, _ = _both(sidx, layout)
    _same_index(got, want)
