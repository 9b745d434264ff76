"""The deep-table path (B15) against the reference, on the CPU.

The port's gate against the reference's ``_deep_chunk`` and its per-layout
condition; the plain sorted forms against the reference's ``_sorted_pk``
(q8 with one rem lane, q12 with two, r < 32 and r >= 32) and
``_sorted_std`` (packed and wide rows), called directly on the same numpy
inputs, in their sliced branch and in their fallback; and the port's
Classifier through the sorted plain path, with both packages' gates
lowered as ``tests/test_deep_sort.py`` lowers the reference's, against
``make_classify_fn`` and golden. Every output is an integer: the
tolerance is exact equality throughout.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pangea_tpu.classify.engine import DeviceIndex as RefDeviceIndex
from pangea_tpu.classify.engine import make_classify_fn
from pangea_tpu.golden import classify_reads_golden
from pangea_tpu.index.build import bucket_of_np
from pangea_tpu.index.shard import extract_pairs
from pangea_tpu.kernels import lookup as RLK
from pangea_tpu_torch.classify import (Classifier, DeviceIndex,
                                       classify_reads, pad_batch)
from pangea_tpu_torch.index.quot import Q12_WAYS
from pangea_tpu_torch.kernels import lookup as LK
from pangea_tpu_torch.kernels import (bucket_sort, bucket_sort_plain,
                                      lookup_q8_sorted_plain,
                                      lookup_q12_sorted_plain,
                                      lookup_std_sorted_plain)

from .helpers import small_world

READ_LEN = 120


def _shape(nb, lanes):
    """A tensor of shape [nb, lanes] that holds one element."""
    return torch.empty(1, 1, dtype=torch.int32).expand(nb, lanes)


# tests/test_deep_sort.py::test_deep_chunk_policy, argument by argument.
POLICY = [((524288, 1 << 20), {}), ((8388608, 1 << 20), {}),
          ((32768, 1 << 20), {}), ((1 << 24, 1 << 18), {}),
          ((8388608, 1 << 24, 512), {}), ((1 << 25, 1 << 24, 512), {}),
          ((8388608, 1 << 22, 512), {}),
          ((1 << 24, 1 << 23, 256), {"min_chunk": 32768}),
          ((1 << 23, 1 << 23, 256), {"min_chunk": 32768})]
GRID = list(itertools.product(
    (1 << 14, 1 << 16, 1 << 20, 2_129_920, 1 << 23, 8_519_680, 1 << 25),
    (1 << 16, 1 << 17, (1 << 17) + 1, 1 << 18, 1 << 19, 1 << 20, 1 << 22,
     1 << 24),
    (256, 512, 768), (8192, 32768)))


@pytest.mark.parametrize("sort_env", ["1", "0"])
def test_gate_equals_the_reference(monkeypatch, sort_env):
    monkeypatch.setenv("PANGEA_DEEP_SORT", sort_env)
    for args, kw in POLICY:
        assert LK._deep_chunk(*args, **kw) == RLK._deep_chunk(*args, **kw)
    for n, nb, row_bytes, min_chunk in GRID:
        want = RLK._deep_chunk(n, nb, row_bytes, min_chunk=min_chunk)
        assert LK._deep_chunk(n, nb, row_bytes, min_chunk=min_chunk) == want
        if row_bytes % 4 or nb & (nb - 1):
            continue
        # The per-layout condition of lookup_q8_jnp / lookup_q12_jnp (min
        # chunk 8192) and lookup_jnp (32768), at this table's row bytes.
        for layout, mc in (("q8", 8192), ("q12", 8192), ("std", 32768)):
            d = RLK._deep_chunk(n, nb, row_bytes, min_chunk=mc) \
                if nb > RLK._DEEP_ROWS else None
            assert LK.takes_sorted(layout, n, _shape(nb, row_bytes // 4)) \
                == (d is not None and n > d), (layout, n, nb, row_bytes)
    if sort_env == "0":
        assert not LK.takes_sorted("q8", 2_129_920, _shape(524_288, 128))


def test_gate_on_the_deep_world():
    """The deep cell: 2,129,920 probes (16,384 reads of 130) take the
    sorted path on its q8 (524,288 x 512 B) and q12 (1,048,576 x 512 B)
    tables; its std table (4,194,304 x 256 B) needs 65,536 reads."""
    n = 16384 * 130
    assert LK.takes_sorted("q8", n, _shape(524_288, 128))
    assert LK.takes_sorted("q12", n, _shape(1_048_576, 128))
    assert not LK.takes_sorted("std", n, _shape(4_194_304, 64))
    assert LK.takes_sorted("std", 4 * n, _shape(4_194_304, 64))
    # Tables at the gate's row count, as the std and config-4 worlds.
    assert not LK.takes_sorted("q12", 4 * n, _shape(131_072, 128))


def _keys_to_lanes(keys):
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def _probes(idx, seed):
    """Every stored key and 3,000 absent ones, shuffled, a tenth invalid
    (with the all-zero lanes K1 writes there)."""
    canon, _ = extract_pairs(idx)
    rng = np.random.default_rng(seed)
    keys = np.concatenate([canon, rng.integers(
        0, 1 << (2 * idx.meta.k), size=3000, dtype=np.uint64)])
    keys = keys[rng.permutation(keys.shape[0])]
    hi, lo = _keys_to_lanes(keys)
    valid = rng.random(keys.shape[0]) >= 0.1
    hi[~valid] = 0
    lo[~valid] = 0
    return keys, hi, lo, valid


def _takes_fallback(b, nb, chunk=2048):
    """Whether the reference's span guard trips on these buckets: some
    sorted chunk spans the slice (``_sorted_apply``, lookup.py:321-325)."""
    sb = np.sort(b)
    sb = np.concatenate([sb, np.full(-sb.size % chunk, sb[-1])])
    sb = sb.reshape(-1, chunk)
    return bool((sb[:, -1] - sb[:, 0] >= min(RLK._DEEP_SLICE, nb)).any())


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                             if a.dtype == np.uint32 else a) for a in arrays]


@pytest.fixture(scope="module")
def world21():
    return small_world(k=21, seed=5, n_reads=1)


@pytest.fixture(scope="module")
def world31():
    return small_world(k=31, seed=5, n_reads=1)


@pytest.mark.parametrize("slice_rows", [1 << 15, 1 << 6],
                         ids=["sliced", "fallback"])
@pytest.mark.parametrize("name,layout", [
    ("world21", "q8"), ("world21", "q12"), ("world31", "q12")],
    ids=["q8", "q12_r_below_32", "q12_r_above_32"])
def test_sorted_quot_plain_equals_sorted_pk(request, monkeypatch, name,
                                            layout, slice_rows):
    """lookup_q8_sorted_plain / lookup_q12_sorted_plain (empty stash) equal
    the reference's _sorted_pk on the same fused rows, buckets and
    remainders: hit = pk != 0, t_in = pk >> 16, t_out = pk & 0xFFFF. With
    a 64-row slice the reference's span guard trips and it takes its
    fallback branch; its output is the same."""
    monkeypatch.setattr(RLK, "_DEEP_SLICE", slice_rows)
    _, _, idx, _ = request.getfixturevalue(name)
    k = idx.meta.k
    ref = RefDeviceIndex.from_index(idx, layout=layout, device_put=False)
    fused = np.asarray(ref.tables["fused"])[0]
    nb = fused.shape[0]
    W = ref.cfg.ways
    r = 2 * k - (nb.bit_length() - 1)
    assert (r >= 32) == (k == 31)
    keys, hi, lo, valid = _probes(idx, seed=k)
    h = (keys * np.uint64(0x9E3779B1)) & np.uint64((1 << (2 * k)) - 1)
    b = (h >> np.uint64(r)).astype(np.int32)
    rem = h & np.uint64((1 << r) - 1)
    rems = ((rem.astype(np.uint32),) if layout == "q8" else
            ((rem & np.uint64(0xFFFFFFFF)).astype(np.uint32),
             (rem >> np.uint64(32)).astype(np.uint32)))
    assert _takes_fallback(b, nb) == (slice_rows < nb)
    pk = np.asarray(RLK._sorted_pk(
        jnp.asarray(fused), jnp.asarray(b), tuple(map(jnp.asarray, rems)),
        jnp.asarray(valid), W, 2048))
    assert pk.shape == keys.shape and (pk != 0).sum() > keys.shape[0] // 2
    args = _torch(hi, lo, valid, fused, np.zeros((5, 0), np.uint32))
    if layout == "q8":
        got = lookup_q8_sorted_plain(*args, k)
    else:
        got = lookup_q12_sorted_plain(*args, k, Q12_WAYS)
    want = ((pk != 0).astype(np.int32), (pk >> 16).astype(np.int32),
            (pk & 0xFFFF).astype(np.int32))
    for g, x in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), x)


@pytest.mark.parametrize("slice_rows", [1 << 15, 1 << 6],
                         ids=["sliced", "fallback"])
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "wide"])
def test_sorted_std_plain_equals_sorted_std(world21, monkeypatch, packed,
                                            slice_rows):
    """lookup_std_sorted_plain (empty stash) equals the reference's
    _sorted_std on the same rows (in K4's record form) and buckets: packed
    rows, and wide rows (Euler stamps past 16 bits, the stamps scaled by
    4,096)."""
    monkeypatch.setattr(RLK, "_DEEP_SLICE", slice_rows)
    tax, _, idx, _ = world21
    tin, tout = tax.tin, tax.tout
    if not packed:
        tin, tout = tin * 4096, tout * 4096
        assert tout.max() > 0xFFFF
    fused = RLK.fuse_table(idx.key_hi, idx.key_lo, idx.val, tin, tout)
    W = idx.meta.ways
    assert fused.shape[1] == (4 if packed else 6) * W
    keys, hi, lo, valid = _probes(idx, seed=3)
    b = bucket_of_np(keys, fused.shape[0]).astype(np.int32)
    assert _takes_fallback(b, fused.shape[0]) == (slice_rows < (1 << 15))
    want = RLK._sorted_std(jnp.asarray(fused), jnp.asarray(b),
                           jnp.asarray(hi), jnp.asarray(lo),
                           jnp.asarray(valid), W, packed, 2048)
    got = lookup_std_sorted_plain(
        *_torch(hi, lo, valid, LK.record_rows(fused.copy(), W),
                np.zeros((5, 0), np.uint32)), W)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert (got[0] != 0).sum() > keys.shape[0] // 2


@pytest.mark.parametrize("k", [21, None], ids=["quotient", "std"])
def test_bucket_sort_plain_groups_its_keys(world21, k):
    """The permutation is one, orders the probes by their keys (a table
    past 2^KEY_BITS rows shares a key among 2^shift rows; invalid probe i
    takes key i mod the key count), as records of each probe's index and
    lanes, with each probe's place among them; the wrapper takes it on CPU
    tensors."""
    _, hi, lo, valid = _probes(world21[2], seed=9)
    hi, lo, valid = _torch(hi, lo, valid)
    nb = 1 << (LK.KEY_BITS + 2)
    assert LK.key_shift(nb) == 2 and LK.key_shift(1 << LK.KEY_BITS) == 0
    records, inv = bucket_sort_plain(hi, lo, valid, nb, k)
    assert records.dtype == inv.dtype == torch.int32
    assert records.shape == (hi.numel(), 4)
    perm = records[:, 0]
    assert torch.equal(torch.sort(perm).values,
                       torch.arange(hi.numel(), dtype=torch.int32))
    assert torch.equal(inv[perm.long()], torch.arange(hi.numel(),
                                                      dtype=torch.int32))
    for j, lanes in enumerate((hi, lo, valid.to(torch.int32)), 1):
        assert torch.equal(records[:, j], lanes[perm.long()])
    keys = LK.bucket_keys(hi, lo, valid, nb, k)
    assert (keys[~valid] == torch.nonzero(~valid)[:, 0] % (nb >> 2)).all()
    keys = keys[perm.long()]
    assert (keys[1:] >= keys[:-1]).all() and int(keys.max()) < nb >> 2
    for a, b in zip(bucket_sort(hi, lo, valid, nb, k), (records, inv)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def world():
    return small_world(n_reads=192)


def _lower_gates(monkeypatch, slice_rows):
    """Both packages' gates lowered, as tests/test_deep_sort.py lowers the
    reference's: 2,048 probes a chunk past 512 rows."""
    monkeypatch.setenv("PANGEA_DEEP_SORT", "1")
    for mod in (RLK, LK):
        monkeypatch.setattr(mod, "_DEEP_ROWS", 1 << 9)
        monkeypatch.setattr(mod, "_DEEP_SLICE", slice_rows)
        monkeypatch.setattr(
            mod, "_deep_chunk",
            lambda n, nb, rb=512, min_chunk=8192: 2048 if n > 2048 else None)


@pytest.mark.parametrize("slice_rows", [1 << 14, 1 << 6])
@pytest.mark.parametrize("layout", ["q8", "q12", "std"])
def test_classifier_sorted_path_matches_jax_and_golden(world, monkeypatch,
                                                       layout, slice_rows):
    """The reference's tables carried over; the port's Classifier and its
    plain path both take the sorted plain form (bucket_sort_plain runs once
    each) and equal the reference's sorted step and golden."""
    _lower_gates(monkeypatch, slice_rows)
    calls = []
    sort = LK.bucket_sort_plain
    monkeypatch.setattr(LK, "bucket_sort_plain",
                        lambda *a, **kw: calls.append(1) or sort(*a, **kw))
    tax, _, idx, rs = world
    ref = RefDeviceIndex.from_index(idx, confidence_threshold=0.05,
                                    layout=layout, device_put=False)
    di = DeviceIndex.from_numpy_tables(ref.tables, ref.cfg, "cpu")
    assert di.fused.shape[0] > LK._DEEP_ROWS
    b = pad_batch(rs.seqs, len(rs.seqs), READ_LEN)
    got = Classifier(di)(torch.from_numpy(b))
    plain = classify_reads(di.tables, torch.from_numpy(b), di.cfg,
                           plain=True)
    assert len(calls) == 2
    want = make_classify_fn(ref.cfg)(ref.tables, jnp.asarray(b))
    gold = classify_reads_golden(rs.seqs, idx, 0.05)
    for key in ("taxon", "best", "nvalid"):
        assert got[key].dtype == torch.int32
        assert torch.equal(got[key], plain[key])
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
        assert got[key].tolist() == [getattr(g, key) for g in gold]
    assert (got["taxon"] != 0).sum() > len(rs.seqs) // 2
