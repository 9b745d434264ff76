"""The q12 layout (the k=31 lane) against the reference, on the CPU.

The table bytes of the one-shard relayout, the plain probe against
``lookup_q12_jnp`` (all three remainder branches: r >= 32, 0 < r < 32 and
r = 0), the k=31 q12 Classifier against the reference's forced-q12 step and
golden, and the layout decision at the edge where q12 begins. Every output
is an integer, so the tolerance is exact equality.
"""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.classify.engine import DeviceIndex as RefDeviceIndex
from pangea_tpu.classify.engine import make_classify_fn as ref_classify_fn
from pangea_tpu.golden import classify_reads_golden
from pangea_tpu.index.shard import shard_tables_quot
from pangea_tpu.kernels.lookup import fuse_stash as ref_fuse_stash
from pangea_tpu.kernels.lookup import lookup_q12_jnp
from pangea_tpu.kernels.lookup import q12_layout as ref_q12_layout
from pangea_tpu_torch.classify import Classifier, DeviceIndex, pad_batch
from pangea_tpu_torch.classify.engine import TAX_KEYS
from pangea_tpu_torch.index import extract_pairs, relayout_q12
from pangea_tpu_torch.index.quot import Q12_WAYS, q12_layout
from pangea_tpu_torch.kernels import fuse_stash, lookup_q12

from .helpers import small_world

READ_LEN = 120


@pytest.fixture(scope="module")
def world31():
    """The reference's q12 world (tests/test_q8.py ``world31``), paired."""
    return small_world(k=31, n_reads=150, paired=True)


@pytest.fixture(scope="module")
def world21():
    return small_world(k=21, seed=3, n_reads=1)


def _equal_arrays(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# name -> (world fixture, ways, load factor)
TABLES = {"k31": ("world31", Q12_WAYS, 0.5),
          "k21_r_below_32": ("world21", Q12_WAYS, 0.5),
          "k31_forced_stash": ("world31", 4, 2.0)}


@pytest.mark.parametrize("name", list(TABLES))
def test_relayout_q12_byte_identical(request, name):
    fixture, ways, load_factor = TABLES[name]
    idx = request.getfixturevalue(fixture)[2]
    got = relayout_q12(idx, ways, load_factor)
    want = shard_tables_quot(idx, 1, ways, load_factor, "q12")
    assert got[2] == want[2]
    assert got[0].dtype == np.uint32
    _equal_arrays(got[:2], want[:2])
    r = 2 * idx.meta.k - (got[2].bit_length() - 1)
    assert (r > 32) == (idx.meta.k == 31)
    if ways == 4:
        assert got[1].shape[2] > 0, "stash not exercised"


def _near_misses(canon, k):
    """Absent keys that share a stored key's bucket and rem_lo but not its
    rem_hi (r > 32): bit 32 of the key's mix flipped, mixed back by the
    inverse multiplier."""
    a = 0x9E3779B1
    mask = np.uint64((1 << (2 * k)) - 1)
    h = (canon * np.uint64(a)) & mask
    inv = np.uint64(pow(a, -1, 1 << (2 * k)))
    return ((h ^ np.uint64(1 << 32)) * inv) & mask


def _probe_keys(canon, k, r, seed=2):
    """Every stored key, then 5,000 absent keys of 2k bits and, where
    r > 32, the near misses of the first 5,000 stored keys."""
    rng = np.random.default_rng(seed)
    absent = rng.integers(0, 1 << (2 * k), size=5000, dtype=np.uint64)
    if r > 32:
        absent = np.concatenate([absent, _near_misses(canon[:5000], k)])
    absent = absent[~np.isin(absent, canon)]
    return np.concatenate([canon, absent])


def _check_lookup(keys, n, fused, stash, k, ways, tax, taxa):
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    valid = np.ones(keys.shape[0], bool)
    valid[n // 3::7] = False                    # invalid probes miss
    got = lookup_q12(*(torch.from_numpy(a) for a in
                       (hi.view(np.int32), lo.view(np.int32), valid,
                        fused.view(np.int32), stash.view(np.int32))),
                     k, ways)
    want = lookup_q12_jnp(jnp.asarray(hi), jnp.asarray(lo),
                          jnp.asarray(valid), jnp.asarray(fused),
                          jnp.asarray(stash), k=k, ways=ways)
    for g, x in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    hit, t_in, t_out = (g.numpy() for g in got)
    stored = valid[:n]
    np.testing.assert_array_equal(hit[:n][stored], 1)
    np.testing.assert_array_equal(t_in[:n][stored], tax.tin[taxa][stored])
    np.testing.assert_array_equal(t_out[:n][stored], tax.tout[taxa][stored])
    assert not hit[:n][~stored].any()
    assert not hit[n:].any()


@pytest.mark.parametrize("name", list(TABLES))
def test_lookup_q12_plain_matches_jax(request, name):
    fixture, ways, load_factor = TABLES[name]
    tax, _, idx, _ = request.getfixturevalue(fixture)
    fused, stash3, nb = relayout_q12(idx, ways, load_factor)
    stash = fuse_stash(stash3[0], tax.tin, tax.tout)
    np.testing.assert_array_equal(stash, ref_fuse_stash(stash3[0], tax.tin,
                                                         tax.tout))
    canon, taxa = extract_pairs(idx)
    keys = _probe_keys(canon, idx.meta.k,
                       2 * idx.meta.k - (nb.bit_length() - 1))
    _check_lookup(keys, canon.shape[0], fused[0], stash, idx.meta.k, ways,
                  tax, taxa)


def test_lookup_q12_plain_matches_jax_at_r0(world21):
    """r = 0: NB clamps to 4^k buckets and the remainder is empty (k=5)."""
    tax = world21[0]
    k = 5
    rng = np.random.default_rng(6)
    canon = np.unique(rng.integers(0, 1 << (2 * k), size=300,
                                   dtype=np.uint64))
    taxa = rng.integers(1, tax.num_taxa + 1, size=canon.shape[0]) \
        .astype(np.int32)
    got = q12_layout(canon, taxa, tax.tin, tax.tout, k, min_nb=1 << 12)
    want = ref_q12_layout(canon, taxa, tax.tin, tax.tout, k, min_nb=1 << 12)
    assert got[2] == want[2] == 1 << (2 * k)
    _equal_arrays(got[:2], want[:2])
    stash = fuse_stash(got[1], tax.tin, tax.tout)
    _check_lookup(_probe_keys(canon, k, 0), canon.shape[0], got[0], stash,
                  k, Q12_WAYS, tax, taxa)


@pytest.mark.parametrize("paired", [True, False], ids=["paired", "single"])
@pytest.mark.parametrize("thr", [0.0, 0.05])
def test_q12_classifier_matches_jax_and_golden(world31, paired, thr):
    """The reference's forced-q12 tables, carried over by from_numpy_tables:
    the port's step equals make_classify_fn and golden, and the tables
    equal the port's own q12 relayout."""
    tax, _, idx, rs = world31
    ref = RefDeviceIndex.from_index(idx, confidence_threshold=thr,
                                    layout="q12", device_put=False)
    assert ref.cfg.layout == "q12"
    di = DeviceIndex.from_numpy_tables(ref.tables, ref.cfg, "cpu")
    fused, stash3, _ = relayout_q12(idx)
    assert torch.equal(di.fused, torch.from_numpy(fused[0].view(np.int32)))
    assert torch.equal(di.stash, torch.from_numpy(
        fuse_stash(stash3[0], tax.tin, tax.tout).view(np.int32)))
    n = len(rs.seqs)
    b1 = pad_batch(rs.seqs, n, READ_LEN)
    b2 = pad_batch(rs.mates, n, READ_LEN)
    got = Classifier(di)(torch.from_numpy(b1),
                         torch.from_numpy(b2) if paired else None)
    args = (jnp.asarray(b1), jnp.asarray(b2)) if paired else \
        (jnp.asarray(b1),)
    want = ref_classify_fn(ref.cfg, paired=paired)(ref.tables, *args)
    gold = classify_reads_golden(rs.seqs, idx, thr,
                                 mates=rs.mates if paired else None)
    for key in ("taxon", "best", "nvalid"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
        np.testing.assert_array_equal(got[key].numpy(),
                                      [getattr(g, key) for g in gold])
    assert (got["taxon"] != 0).sum() > n // 2


@pytest.mark.parametrize("k,n_kmers,layout", [
    (31, 2_000_000, "std"), (31, 2_097_152, "std"), (31, 2_097_153, "q12"),
    (31, 2_559_507, "q12"), (21, 2_559_507, "q8"), (27, 40_000_000, "q12")])
def test_from_index_picks_q12_as_the_reference_does(world31, world21, k,
                                                    n_kmers, layout):
    """The decision rests on the index's k-mer count: a small index whose
    meta claims n_kmers is laid out as the reference's from_index lays out
    the same claim, and as the named layout (q12 from 2,097,153 k-mers at
    k=31, where a std table at W=32 leaves the reference's fast regime)."""
    idx = copy.copy(world31[2] if k == 31 else world21[2])
    idx.meta = dataclasses.replace(idx.meta, k=k, n_kmers=n_kmers)
    ref = RefDeviceIndex.from_index(idx, device_put=False)
    di = DeviceIndex.from_index(idx, "cpu")
    assert di.cfg.layout == ref.cfg.layout == layout
    if layout == "q12":
        assert di.cfg.ways == ref.cfg.ways == Q12_WAYS
        a = DeviceIndex.from_numpy_tables(ref.tables, ref.cfg, "cpu")
        assert a.cfg == di.cfg
        for x, y in ((a.fused, di.fused), (a.stash, di.stash),
                     *((a.tax[key], di.tax[key]) for key in TAX_KEYS)):
            assert x.dtype == y.dtype and torch.equal(x, y)
