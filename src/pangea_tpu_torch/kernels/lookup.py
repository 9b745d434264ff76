"""hash32 and the table probes (SEMANTICS.md §4-5).

Counterpart of ``pangea_tpu/kernels/lookup.py``: ``mix32``/``hash32``
(``mix32_jnp``/``hash32_jnp``), ``lookup_q8`` (``lookup_q8_jnp``, kernel K2),
``lookup_q12`` (``lookup_q12_jnp``, K2's q12 form) and ``lookup_std``
(``lookup_jnp``, kernel K4; ``lookup_std_owned`` is its owner mask for one
shard of an S-shard table, K4's masked form), with the host builders of
the std device rows, ``fuse_table`` and ``fuse_stash``. The std probes take
their rows in the record form, ``record_rows`` of ``fuse_table``'s: the same
lanes with each slot's payload in one record, which placement
(``classify/engine.py`` ``DeviceIndex``) lays out. The port has no
counterpart of the reference's chunked gather (``_chunked_pk``): it leaves
the outputs unchanged.

The deep-table path (the reference's ``_sorted_apply``, ``_sorted_pk`` and
``_sorted_std`` behind ``_deep_chunk``): :func:`takes_sorted` is the
reference's gate, :func:`bucket_sort` (kernel K9) groups the probes by
bucket, and ``lookup_q8_sorted``, ``lookup_q12_sorted`` and
``lookup_std_sorted`` probe them in that order and write each output at
its probe's place. Their outputs equal the unsorted probes', as the
reference's do.

Lane rule: 32-bit unsigned lanes live in ``torch.int32`` tensors holding
the uint32 bit pattern. The plain versions widen them to int64
(:func:`widen`), keep every product below 2^63 by multiplying in 16-bit
halves (:func:`_mul32`) and narrow back at the end (:func:`narrow`).
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from ..index.quot import Q12_WAYS
from . import _build

M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_Q8_A = 0x9E3779B1
_PLAIN_CHUNK = 1 << 16               # probes a plain-lookup step
_PERMUTE_ROWS = 1 << 16              # rows a step of record_rows
# The reference's deep-table gate (lookup.py:271-297): tables past
# _DEEP_ROWS rows take the sorted lookup when enough probes fall on each
# row. The constants decide which path runs, as in the reference; the port
# probes the whole table, so _DEEP_SLICE only enters the gate's arithmetic.
_DEEP_ROWS = 1 << 17
_DEEP_SLICE = 1 << 15
# K9 groups probes by bucket >> key_shift(NB): at most 2^KEY_BITS keys.
KEY_BITS = 10
# K9 and K10 (csrc/bucket_sort.cu kTile): a block bins a tile of BIN_TILE
# probes.
BIN_TILE = 8192


def _deep_chunk(n: int, nb: int, row_bytes: int = 512,
                min_chunk: int = 8192) -> int | None:
    """The reference's ``_deep_chunk``: probes a slice-chunk (expected
    bucket span nb * chunk / n at most _DEEP_SLICE / 2), or None when the
    sorted path does not pay: too few probes a row (under min_chunk), a
    table past 2^31 bytes, or ``PANGEA_DEEP_SORT`` other than 1."""
    if os.environ.get("PANGEA_DEEP_SORT", "1") != "1":
        return None
    c = n * (_DEEP_SLICE // 2) // max(nb, 1)
    if c < min_chunk or nb * row_bytes > (1 << 31):
        return None
    return 1 << min(c.bit_length() - 1, 19)


def takes_sorted(layout: str, n: int, fused: torch.Tensor) -> bool:
    """Whether n probes of a ``layout`` table take the sorted lookup: the
    reference's condition ``nb > _DEEP_ROWS and dchunk is not None and n >
    dchunk``, with min_chunk 8192 for q8 and q12 and 32768 for std
    (lookup.py:749-751, :665-667, :150-152)."""
    nb, lanes = fused.shape
    if nb <= _DEEP_ROWS:
        return False
    dchunk = _deep_chunk(n, nb, lanes * 4,
                         min_chunk=32768 if layout == "std" else 8192)
    return dchunk is not None and n > dchunk


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the uint32 value."""
    return x.to(torch.int64) & M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 bit pattern of its low 32 bits."""
    x = x & M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 for v in [0, 2^32) int64 and a constant c < 2^32,
    with every intermediate below 2^49."""
    return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix32(v: torch.Tensor) -> torch.Tensor:
    v = v ^ (v >> 16)
    v = _mul32(v, 0x85EBCA6B)
    v = v ^ (v >> 13)
    v = _mul32(v, 0xC2B2AE35)
    return v ^ (v >> 16)


def _hash32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """hash32 on widened lanes; returns the uint32 value as int64."""
    return _mix32(_mix32(lo ^ _GOLD) ^ hi)


def mix32(v: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 fmix32 finalizer on int32 bit patterns."""
    return narrow(_mix32(widen(v)))


def hash32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """fmix32(fmix32(lo ^ 0x9E3779B9) ^ hi) on int32 bit patterns."""
    return narrow(_hash32(widen(hi), widen(lo)))


def _q8_hash(hi, lo, k: int):
    """h = (K * A) mod 2^(2k), int64, for the widened lanes of K."""
    m = 2 * k
    p0 = lo * (_Q8_A & 0xFFFF)                  # < 2^48
    p1 = lo * (_Q8_A >> 16)                     # < 2^48
    h_lo = (p0 + ((p1 & 0xFFFF) << 16)) & M32
    if m > 32:
        umulh = ((p0 >> 16) + p1) >> 16         # high half of lo * A
        h_hi = (umulh + _mul32(hi, _Q8_A)) & ((1 << (m - 32)) - 1)
    else:
        h_lo = h_lo & ((1 << m) - 1)
        h_hi = torch.zeros_like(h_lo)
    return (h_hi << 32) | h_lo


def _q8_split(hi, lo, k: int, log2nb: int):
    """(bucket, rem) int64 of h = (K * A) mod 2^(2k) for widened lanes; rem
    holds the low r = 2k - log2nb bits (up to 62 for q12)."""
    r = 2 * k - log2nb
    h = _q8_hash(hi, lo, k)
    return h >> r, h & ((1 << r) - 1)


def _q8_geometry(fused: torch.Tensor, k: int):
    nb = fused.shape[0]
    log2nb = nb.bit_length() - 1
    r = 2 * k - log2nb
    if nb != 1 << log2nb or not 0 <= r <= 31:
        raise ValueError(f"q8 table with NB={nb} and k={k}: the remainder "
                         f"width {r} is outside [0, 31]")
    return log2nb, fused.shape[1] // 2


def _q12_geometry(fused: torch.Tensor, k: int, ways: int) -> int:
    nb, lanes = fused.shape
    log2nb = nb.bit_length() - 1
    r = 2 * k - log2nb
    if nb != 1 << log2nb or not 0 <= r <= 62 or lanes < 3 * ways:
        raise ValueError(f"q12 table {tuple(fused.shape)} with W={ways} and "
                         f"k={k}: want a power-of-two NB, a remainder width "
                         f"in [0, 62] (got {r}) and at least 3W lanes")
    return log2nb


def key_shift(nb: int) -> int:
    """K9 groups the probes of an NB-row table by bucket >> key_shift(NB):
    at most 2^KEY_BITS groups of 2^key_shift adjacent rows."""
    return max(nb.bit_length() - 1 - KEY_BITS, 0)


def bucket_keys(hi, lo, valid, nb: int, k: int | None = None):
    """int64 [N] sort key of each probe, flattened: its bucket >>
    key_shift(nb), where the bucket is the q8/q12 quotient bucket at k
    (h >> r), or, for k None, the std bucket hash32 & (nb - 1). Invalid
    probe i, whose row is never read, gets key i mod (nb >> key_shift(nb)),
    so that the invalid probes share no one key."""
    hi, lo, valid = (x.reshape(-1) for x in (hi, lo, valid))
    if k is None:
        bucket = _hash32(widen(hi), widen(lo)) & (nb - 1)
    else:
        bucket, _ = _q8_split(widen(hi), widen(lo), k, nb.bit_length() - 1)
    shift = key_shift(nb)
    spread = torch.arange(hi.numel(), device=hi.device) & ((nb >> shift) - 1)
    return torch.where(valid, bucket >> shift, spread)


def bucket_sort_plain(hi, lo, valid, nb: int, k: int | None = None):
    """Plain version of K9: (records, inv). records: the flattened probes
    ordered by :func:`bucket_keys` (a stable sort), int32 [N, 4] (index,
    hi, lo, valid): each probe's index in the input, then its lanes. inv:
    int32 [N], each probe's place in records."""
    perm = torch.sort(bucket_keys(hi, lo, valid, nb, k),
                      stable=True).indices
    records = torch.stack([perm.to(torch.int32), hi.reshape(-1)[perm],
                           lo.reshape(-1)[perm],
                           valid.reshape(-1)[perm].to(torch.int32)], dim=1)
    inv = torch.empty(perm.numel(), dtype=torch.int32, device=perm.device)
    inv[perm] = torch.arange(perm.numel(), dtype=torch.int32,
                             device=perm.device)
    return records, inv


def k9_scratch(n: int, n_keys: int) -> int:
    """Int32 entries of K9's key counts for n probes over ``n_keys`` keys:
    a row a tile of BIN_TILE probes, then the keys' totals."""
    return (-(-n // BIN_TILE) + 1) * n_keys


def bucket_sort(hi, lo, valid, nb: int, k: int | None = None):
    """The probes sorted by bucket, (records, inv) as
    :func:`bucket_sort_plain` returns them: the plain version for CPU
    tensors, kernel K9 (``csrc/bucket_sort.cu``) for CUDA tensors. K9
    counts each tile's keys, scans the counts key by key over the tiles and
    writes each tile's records as runs of their keys (tiles of BIN_TILE
    probes, the counts in :func:`k9_scratch`'s scratch), in ascending
    :func:`bucket_keys` order; within a key the order is unspecified (each
    probe's outputs depend on it alone)."""
    dev = _build.dispatch_device(hi, lo, valid)
    if dev is None:
        return bucket_sort_plain(hi, lo, valid, nb, k)
    _build.check(hi, torch.int32, name="hi")
    _build.check(lo, torch.int32, shape=hi.shape, name="lo")
    _build.check(valid, torch.bool, shape=hi.shape, name="valid")
    log2nb = nb.bit_length() - 1
    if nb != 1 << log2nb or (k is not None and not
                             (1 <= k <= 31 and 0 <= 2 * k - log2nb <= 62)):
        raise ValueError(f"bucket_sort: NB={nb}, k={k}")
    shift = key_shift(nb)
    counts = torch.empty(k9_scratch(hi.numel(), nb >> shift),
                         dtype=torch.int32, device=dev)
    records = torch.empty((hi.numel(), 4), dtype=torch.int32, device=dev)
    inv = torch.empty(hi.numel(), dtype=torch.int32, device=dev)
    _build.launch("pangea_bucket_sort", dev, hi.data_ptr(), lo.data_ptr(),
                  valid.data_ptr(), hi.numel(), nb, k or 0, shift,
                  counts.data_ptr(), records.data_ptr(), inv.data_ptr())
    bucket_sort.launches += 1
    return records, inv


bucket_sort.launches = 0


def _sorted_plain(lookup_plain, order, shape, *args):
    """lookup_plain on the sorted probes of ``order`` (bucket_sort's
    output), its outputs gathered back into the probes' order, in
    ``shape``."""
    records, inv = order
    outs = lookup_plain(records[:, 1], records[:, 2], records[:, 3] != 0,
                        *args)
    return tuple(o[inv.long()].reshape(shape) for o in outs)


def _check_order(order, hi) -> None:
    """Raise unless order is bucket_sort's output for probes like hi."""
    records, inv = order
    _build.check(records, torch.int32, shape=(hi.numel(), 4), name="records")
    _build.check(inv, torch.int32, shape=(hi.numel(),), name="inv")
    for t in order:
        if t.device != hi.device:
            raise ValueError(f"K9's order on {t.device}, probes on "
                             f"{hi.device}")


def _launch_lookup(name: str, dev, hi, order, *args, tail=()):
    """Launch the lookup ``name`` with ``args`` (its arguments before
    K9's order) and ``tail`` (those after its outputs) and return its
    outputs, int32 like hi. Sorted (``order`` given), it writes one record
    a probe in sorted order, and K9's restore gathers them back into the
    probes' order."""
    outs = [torch.empty(hi.shape, dtype=torch.int32, device=dev)
            for _ in range(3)]
    if order is None:
        _build.launch(name, dev, *args, None, None,
                      *(o.data_ptr() for o in outs), *tail)
        return tuple(outs)
    records, inv = order
    sorted_out = torch.empty_like(records)
    _build.launch(name, dev, *args, records.data_ptr(),
                  sorted_out.data_ptr(), None, None, None, *tail)
    _build.launch("pangea_bucket_restore", dev, inv.data_ptr(),
                  sorted_out.data_ptr(), hi.numel(),
                  *(o.data_ptr() for o in outs))
    return tuple(outs)


def _lookup_quot_plain(hi, lo, valid, fused, stash, k: int, log2nb: int,
                       W: int, q12: bool):
    """The q8 and q12 probes: the rem lanes of the bucket's row (q12: rem_lo
    lanes [0, W) and rem_hi lanes [W, 2W)) select the payload lanes that
    follow them, whose wrapping uint32 sum is pk; then the stash scan."""
    shape = hi.shape
    hi, lo, valid = hi.reshape(-1), lo.reshape(-1), valid.reshape(-1)
    outs = []
    for s in range(0, max(hi.shape[0], 1), _PLAIN_CHUNK):
        h_c, l_c, v_c = (x[s:s + _PLAIN_CHUNK] for x in (hi, lo, valid))
        bucket, rem = _q8_split(widen(h_c), widen(l_c), k, log2nb)
        rows = fused[bucket]                            # [n, lanes]
        match = v_c[:, None] & (widen(rows[:, :W]) == (rem & M32)[:, None])
        if q12:
            match &= widen(rows[:, W:2 * W]) == (rem >> 32)[:, None]
        payload = rows[:, (2 if q12 else 1) * W:(3 if q12 else 2) * W]
        pk = torch.where(match, widen(payload), 0).sum(1) & M32
        t_in = pk >> 16
        t_out = pk & 0xFFFF
        hit = (pk != 0).to(torch.int64)
        if stash.shape[1]:
            shit = (v_c[:, None] & (h_c[:, None] == stash[0][None, :])
                    & (l_c[:, None] == stash[1][None, :]))
            t_in = t_in + torch.where(shit, widen(stash[3])[None, :],
                                      0).sum(1)
            t_out = t_out + torch.where(shit, widen(stash[4])[None, :],
                                        0).sum(1)
            hit = hit + shit.sum(1)
        outs.append((narrow(hit), narrow(t_in), narrow(t_out)))
    return tuple(torch.cat(o).reshape(shape) for o in zip(*outs))


def lookup_q8_plain(hi, lo, valid, fused, stash, k: int):
    """Plain PyTorch q8 probe (any device). hi/lo int32 bit patterns and
    valid bool, any shape; fused int32 [NB, 2W] (rem lanes, then payload
    lanes); stash int32 [5, S]. Returns (hit, t_in, t_out) int32 like hi."""
    log2nb, W = _q8_geometry(fused, k)
    return _lookup_quot_plain(hi, lo, valid, fused, stash, k, log2nb, W,
                              q12=False)


def _check_quot(hi, lo, valid, fused, stash, k: int) -> None:
    _build.check(hi, torch.int32, name="hi")
    _build.check(lo, torch.int32, shape=hi.shape, name="lo")
    _build.check(valid, torch.bool, shape=hi.shape, name="valid")
    _build.check(fused, torch.int32, ndim=2, name="fused")
    _build.check(stash, torch.int32, ndim=2, name="stash")
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside 1..31")
    if stash.shape[0] != 5:
        raise ValueError(f"stash {tuple(stash.shape)} is not [5, S]")


def _q8_kernel(dev, hi, lo, valid, fused, stash, k: int, order,
               plan: LookupPlan | None = None):
    """K2 on CUDA tensors; K9's order selects its sorted form, and ``plan``
    overrides :func:`quot_plan` (kernels.lookup_sweep)."""
    _check_quot(hi, lo, valid, fused, stash, k)
    _, W = _q8_geometry(fused, k)
    if fused.shape[1] != 2 * W:
        raise ValueError(f"fused {tuple(fused.shape)} is not a q8 table")
    return _launch_lookup(
        "pangea_lookup_q8", dev, hi, order, hi.data_ptr(), lo.data_ptr(),
        valid.data_ptr(), hi.numel(), fused.data_ptr(), fused.shape[0], W,
        stash.data_ptr(), stash.shape[1], k,
        tail=_quot_tail(dev, hi, fused, stash, W, False, order, plan))


def lookup_q8(hi, lo, valid, fused, stash, k: int):
    """q8 probe: the plain version for CPU tensors, kernel K2
    (``csrc/lookup_q8.cu``) for CUDA tensors. Same contract as
    :func:`lookup_q8_plain`."""
    dev = _build.dispatch_device(hi, lo, valid, fused, stash)
    if dev is None:
        return lookup_q8_plain(hi, lo, valid, fused, stash, k)
    out = _q8_kernel(dev, hi, lo, valid, fused, stash, k, None)
    lookup_q8.launches += 1
    return out


lookup_q8.launches = 0


def lookup_q8_sorted_plain(hi, lo, valid, fused, stash, k: int,
                           order=None):
    """Plain sorted q8 probe: the probes sorted by bucket (``order``, by
    default :func:`bucket_sort_plain`'s), probed by
    :func:`lookup_q8_plain`, each output put back at its probe's place.
    Equal to :func:`lookup_q8_plain`."""
    if order is None:
        order = bucket_sort_plain(hi, lo, valid, fused.shape[0], k)
    return _sorted_plain(lookup_q8_plain, order, hi.shape, fused, stash, k)


def lookup_q8_sorted(hi, lo, valid, fused, stash, k: int, order=None):
    """Sorted q8 probe: the plain version for CPU tensors; for CUDA tensors
    K9 (unless its output ``order`` is given), then K2's sorted form, which
    probes the sorted probes in turn, and K9's restore. Same contract as
    :func:`lookup_q8_plain`."""
    dev = _build.dispatch_device(hi, lo, valid, fused, stash)
    if dev is None:
        return lookup_q8_sorted_plain(hi, lo, valid, fused, stash, k, order)
    if order is None:
        order = bucket_sort(hi, lo, valid, fused.shape[0], k)
    _check_order(order, hi)
    out = _q8_kernel(dev, hi, lo, valid, fused, stash, k, order)
    lookup_q8_sorted.launches += 1
    return out


lookup_q8_sorted.launches = 0


def lookup_q12_plain(hi, lo, valid, fused, stash, k: int,
                     ways: int = Q12_WAYS):
    """Plain PyTorch q12 probe (any device): the q8 probe with the
    remainder in two lanes. fused int32 [NB, RL >= 3W] (rem_lo, rem_hi and
    payload lanes, then pad); stash int32 [5, S]. Returns (hit, t_in, t_out)
    int32 like hi."""
    log2nb = _q12_geometry(fused, k, ways)
    return _lookup_quot_plain(hi, lo, valid, fused, stash, k, log2nb, ways,
                              q12=True)


def _q12_kernel(dev, hi, lo, valid, fused, stash, k: int, ways: int,
                order, plan: LookupPlan | None = None):
    """K2's q12 form on CUDA tensors; K9's order selects its sorted form,
    and ``plan`` overrides :func:`quot_plan` (kernels.lookup_sweep)."""
    _check_quot(hi, lo, valid, fused, stash, k)
    _q12_geometry(fused, k, ways)
    return _launch_lookup(
        "pangea_lookup_q12", dev, hi, order, hi.data_ptr(), lo.data_ptr(),
        valid.data_ptr(), hi.numel(), fused.data_ptr(), fused.shape[0], ways,
        fused.shape[1], stash.data_ptr(), stash.shape[1], k,
        tail=_quot_tail(dev, hi, fused, stash, ways, True, order, plan))


def lookup_q12(hi, lo, valid, fused, stash, k: int, ways: int = Q12_WAYS):
    """q12 probe: the plain version for CPU tensors, kernel K2's q12 form
    (``csrc/lookup_q8.cu``) for CUDA tensors. Same contract as
    :func:`lookup_q12_plain`."""
    dev = _build.dispatch_device(hi, lo, valid, fused, stash)
    if dev is None:
        return lookup_q12_plain(hi, lo, valid, fused, stash, k, ways)
    out = _q12_kernel(dev, hi, lo, valid, fused, stash, k, ways, None)
    lookup_q12.launches += 1
    return out


lookup_q12.launches = 0


def lookup_q12_sorted_plain(hi, lo, valid, fused, stash, k: int,
                            ways: int = Q12_WAYS, order=None):
    """Plain sorted q12 probe, as :func:`lookup_q8_sorted_plain`. Equal to
    :func:`lookup_q12_plain`."""
    if order is None:
        order = bucket_sort_plain(hi, lo, valid, fused.shape[0], k)
    return _sorted_plain(lookup_q12_plain, order, hi.shape, fused, stash, k,
                         ways)


def lookup_q12_sorted(hi, lo, valid, fused, stash, k: int,
                      ways: int = Q12_WAYS, order=None):
    """Sorted q12 probe: the plain version for CPU tensors; for CUDA tensors
    K9 (unless ``order`` is given), then the sorted form of K2's q12 form.
    Same contract as :func:`lookup_q12_plain`."""
    dev = _build.dispatch_device(hi, lo, valid, fused, stash)
    if dev is None:
        return lookup_q12_sorted_plain(hi, lo, valid, fused, stash, k, ways,
                                       order)
    if order is None:
        order = bucket_sort(hi, lo, valid, fused.shape[0], k)
    _check_order(order, hi)
    out = _q12_kernel(dev, hi, lo, valid, fused, stash, k, ways, order)
    lookup_q12_sorted.launches += 1
    return out


lookup_q12_sorted.launches = 0


def fuse_table(key_hi, key_lo, val, tin, tout) -> np.ndarray:
    """Host: [..., NB, W] x3 table arrays and the taxonomy's Euler arrays
    ([T+1]) -> one uint32 device row a bucket carrying the hit taxon's
    Euler interval (the reference's ``fuse_table``):

    - packed [..., NB, 4W] = [hi | lo | val | tin << 16 | tout] when the
      stamps fit 16 bits (tout <= 0xFFFF);
    - wide [..., NB, 6W] = [hi | lo | val | tin | tout | pad] otherwise.

    K4 reads these rows as :func:`record_rows` permutes them: [hi | lo |
    (val, pk) x W] packed, [hi | lo | (val, tin, tout, 0) x W] wide.
    """
    key_hi = np.asarray(key_hi, dtype=np.uint32)
    val = np.asarray(val, dtype=np.int32)
    tin = np.asarray(tin, dtype=np.int32)
    tout = np.asarray(tout, dtype=np.int32)
    if int(tout.max(initial=0)) <= 0xFFFF:
        pk = (tin[val].astype(np.uint32) << np.uint32(16)) \
            | tout[val].astype(np.uint32)
        return np.concatenate(
            [key_hi, np.asarray(key_lo, dtype=np.uint32),
             val.view(np.uint32), pk], axis=-1)
    pad = np.zeros(key_hi.shape, dtype=np.uint32)
    return np.concatenate(
        [key_hi, np.asarray(key_lo, dtype=np.uint32),
         val.view(np.uint32),
         tin[val].view(np.uint32),
         tout[val].view(np.uint32), pad], axis=-1)


def record_rows(fused, ways: int, inverse: bool = False):
    """A :func:`fuse_table` table's rows in the record form K4 reads, in
    place (numpy array or tensor, in chunks of _PERMUTE_ROWS rows, so that
    a table on the card needs no second copy of itself), and returned: the
    key lanes stay, and the payload lanes become one record a slot,

    - packed [hi W | lo W | (val, pk) x W]: slot j's 8-byte record at lane
      2W + 2j;
    - wide [hi W | lo W | (val, tin, tout, 0) x W]: slot j's 16-byte record
      at lane 2W + 4j,

    so that a hit reads one 32-byte sector of payload, not two or three.
    The row keeps its lanes and its width. ``inverse=True`` gives the
    reference's form back (its exact inverse)."""
    nb, lanes = fused.shape
    m = lanes // ways - 2               # payload lanes a slot: 2 or 4
    for s in range(0, nb, _PERMUTE_ROWS):
        pay = fused[s:s + _PERMUTE_ROWS, 2 * ways:]
        n = pay.shape[0]
        by = (n, ways, m) if inverse else (n, m, ways)
        fused[s:s + _PERMUTE_ROWS, 2 * ways:] = \
            pay.reshape(by).swapaxes(1, 2).reshape(n, m * ways)
    return fused


def fuse_stash(stash, tin, tout) -> np.ndarray:
    """Host: uint32 [3, S] (hi, lo, val-bits) -> uint32 [5, S] with the
    taxon's tin and tout appended as rows 3 and 4 (padding columns keep
    val 0 and an EMPTY_HI key, which no valid probe matches)."""
    stash = np.asarray(stash, dtype=np.uint32)
    sval = stash[2].view(np.int32)
    tin = np.asarray(tin, dtype=np.int32)
    tout = np.asarray(tout, dtype=np.int32)
    return np.concatenate(
        [stash, tin[sval].view(np.uint32)[None, :],
         tout[sval].view(np.uint32)[None, :]], axis=0)


def _std_geometry(fused: torch.Tensor, ways: int) -> bool:
    """True for packed rows, False for wide; raises for anything else."""
    nb, lanes = fused.shape
    if nb < 1 or nb & (nb - 1) or lanes not in (4 * ways, 6 * ways):
        raise ValueError(f"std table {tuple(fused.shape)} with W={ways}: "
                         "want a power-of-two NB and 4W (packed) or 6W "
                         "(wide) lanes")
    return lanes == 4 * ways


def _owner_shift(owner) -> tuple[int, int]:
    """(32 - log2 S, shard id) of an owner mask (n_shards, shard_id), or
    (0, 0) for none (None or one shard)."""
    if owner is None or owner[0] == 1:
        return 0, 0
    n_shards, shard_id = owner
    log2s = n_shards.bit_length() - 1
    if n_shards != 1 << log2s or not 0 <= shard_id < n_shards:
        raise ValueError(f"owner mask: shard {shard_id} of {n_shards}")
    return 32 - log2s, shard_id


def lookup_std_plain(hi, lo, valid, fused, stash, ways: int, owner=None):
    """Plain PyTorch std probe (any device), one shard. hi/lo int32 bit
    patterns and valid bool, any shape; fused int32 [NB, 4W | 6W] in the
    record form (:func:`record_rows`); stash int32 [5, S]; owner: None, or
    (n_shards, shard_id) of a table that is one shard of n_shards, where a
    probe whose owner (the top log2 n_shards bits of hash32) is another
    shard gives zeros (the reference's owner mask, lookup.py:117-120). Returns (taxon, t_in, t_out) int32
    like hi: the hit taxon (0 = miss, not owned or invalid) and its Euler
    interval; every sum wraps in 32 bits, as the reference's do."""
    packed = _std_geometry(fused, ways)
    shift, shard_id = _owner_shift(owner)
    W = ways
    shape = hi.shape
    hi, lo, valid = hi.reshape(-1), lo.reshape(-1), valid.reshape(-1)
    mask = fused.shape[0] - 1
    outs = []
    for s in range(0, max(hi.shape[0], 1), _PLAIN_CHUNK):
        h_c, l_c, v_c = (x[s:s + _PLAIN_CHUNK] for x in (hi, lo, valid))
        h = _hash32(widen(h_c), widen(l_c))
        if shift:
            v_c = v_c & ((h >> shift) == shard_id)
        bucket = h & mask
        rows = fused[bucket]                            # [n, 4W | 6W]
        match = (v_c[:, None] & (rows[:, :W] == h_c[:, None])
                 & (rows[:, W:2 * W] == l_c[:, None]))
        rec = rows[:, 2 * W:].reshape(-1, W, 2 if packed else 4)

        def field_sum(f):
            return torch.where(match, rec[:, :, f].long(), 0).sum(1)

        taxon = field_sum(0)
        if packed:
            pk = torch.where(match, widen(rec[:, :, 1]), 0).sum(1) & M32
            t_in, t_out = pk >> 16, pk & 0xFFFF
        else:
            t_in, t_out = field_sum(1), field_sum(2)
        if stash.shape[1]:
            shit = (v_c[:, None] & (h_c[:, None] == stash[0][None, :])
                    & (l_c[:, None] == stash[1][None, :]))
            taxon, t_in, t_out = (
                acc + torch.where(shit, stash[r].long()[None, :], 0).sum(1)
                for acc, r in ((taxon, 2), (t_in, 3), (t_out, 4)))
        outs.append((narrow(taxon), narrow(t_in), narrow(t_out)))
    return tuple(torch.cat(o).reshape(shape) for o in zip(*outs))


def lookup_std(hi, lo, valid, fused, stash, ways: int):
    """std probe: the plain version for CPU tensors, kernel K4
    (``csrc/lookup_std.cu``) for CUDA tensors. Same contract as
    :func:`lookup_std_plain` without an owner mask."""
    dev = _build.dispatch_device(hi, lo, valid, fused, stash)
    if dev is None:
        return lookup_std_plain(hi, lo, valid, fused, stash, ways)
    out = _std_kernel(dev, hi, lo, valid, fused, stash, ways, None, None)
    lookup_std.launches += 1
    return out


lookup_std.launches = 0


def lookup_std_owned(hi, lo, valid, fused, stash, ways: int, owner):
    """std probe of one shard of a sharded table, owner = (n_shards,
    shard_id): the plain version for CPU tensors, K4's masked form for
    CUDA tensors. Same contract as :func:`lookup_std_plain`."""
    dev = _build.dispatch_device(hi, lo, valid, fused, stash)
    if dev is None:
        return lookup_std_plain(hi, lo, valid, fused, stash, ways, owner)
    out = _std_kernel(dev, hi, lo, valid, fused, stash, ways, None, owner)
    lookup_std_owned.launches += 1
    return out


lookup_std_owned.launches = 0


def lookup_std_sorted_plain(hi, lo, valid, fused, stash, ways: int,
                            order=None, owner=None):
    """Plain sorted std probe, as :func:`lookup_q8_sorted_plain` with the
    std bucket. Equal to :func:`lookup_std_plain`."""
    if order is None:
        order = bucket_sort_plain(hi, lo, valid, fused.shape[0])
    return _sorted_plain(lookup_std_plain, order, hi.shape, fused, stash,
                         ways, owner)


def lookup_std_sorted(hi, lo, valid, fused, stash, ways: int, order=None,
                      owner=None):
    """Sorted std probe: the plain version for CPU tensors; for CUDA tensors
    K9 (unless ``order`` is given), then K4's sorted form (with the owner
    mask when ``owner`` is given). Same contract as
    :func:`lookup_std_plain`."""
    dev = _build.dispatch_device(hi, lo, valid, fused, stash)
    if dev is None:
        return lookup_std_sorted_plain(hi, lo, valid, fused, stash, ways,
                                       order, owner)
    if order is None:
        order = bucket_sort(hi, lo, valid, fused.shape[0])
    _check_order(order, hi)
    out = _std_kernel(dev, hi, lo, valid, fused, stash, ways, order, owner)
    lookup_std_sorted.launches += 1
    return out


lookup_std_sorted.launches = 0


# K2's and K4's launch (lookup_plan), from kernels.lookup_sweep on an
# NVIDIA H100 80GB HBM3: warps a block and blocks an SM (64 registers a
# thread fit 1,024 threads an SM); the L2 policy mode of the unsorted and
# the sorted form; the stash staged in shared memory up to STASH_SMEM_MAX
# bytes. K4: the probes whose key loads a group issues together, by W, and
# the W it is specialised for (auto_ways' choices). K2: the W it is
# specialised for, by form (index/quot.py Q8_WAYS, Q12_WAYS).
LOOKUP_WARPS = 8
LOOKUP_BLOCKS_PER_SM = 4
LOOKUP_L2 = {False: 1, True: 2}       # by sorted form
STASH_ROWS = 5
STASH_SMEM_MAX = 48 * 1024
STD_BATCH = {16: 4, 32: 2}
STD_BATCH_GENERIC = 2
STD_SPECS = (16, 32)
QUOT_SPECS = {False: 64, True: 42}    # by q12


class LookupPlan(NamedTuple):
    """K2's or K4's launch: ``grid`` blocks of ``warps`` warps, each warp
    taking 32 consecutive probes a step, one a lane; a group of 8 lanes
    probes its lanes' rows ``batch`` at a time, their key loads issued
    together; ``spec`` the W of the specialised body (0: the generic one);
    ``l2`` the L2 policy mode (0: all evict-normal; 1: keys evict-last,
    the rest evict-first; 2: keys evict-last, payload (and K2's rem_hi)
    evict-normal, streams evict-first); ``smem`` the shared bytes that
    stage the stash (0: read from device memory)."""
    grid: int
    warps: int
    batch: int
    spec: int
    l2: int
    smem: int


def lookup_plan(n: int, spec: int, batch: int, stash_cols: int,
                sorted_form: bool, sms: int) -> LookupPlan:
    """The launch for n probes of the body ``spec`` at ``batch``, with a
    stash of ``stash_cols`` columns, unsorted or ``sorted_form``, on a
    card of ``sms`` SMs: a persistent grid of LOOKUP_BLOCKS_PER_SM blocks
    an SM, capped by the work; the stash staged where it fits
    STASH_SMEM_MAX bytes."""
    if n < 0 or stash_cols < 0 or sms < 1:
        raise ValueError(f"n={n}, stash_cols={stash_cols}, sms={sms}")
    grid = min(sms * LOOKUP_BLOCKS_PER_SM, -(-n // (LOOKUP_WARPS * 32)))
    smem = STASH_ROWS * 4 * stash_cols
    return LookupPlan(grid, LOOKUP_WARPS, batch, spec,
                      LOOKUP_L2[bool(sorted_form)],
                      smem if smem <= STASH_SMEM_MAX else 0)


@functools.lru_cache(maxsize=256)
def std_plan(n: int, ways: int, stash_cols: int, sorted_form: bool,
             sms: int) -> LookupPlan:
    """K4's launch for n probes of a table of ``ways`` slots a row
    (:func:`lookup_plan`)."""
    if ways < 1:
        raise ValueError(f"ways={ways}")
    spec = ways if ways in STD_SPECS else 0
    return lookup_plan(n, spec, STD_BATCH.get(spec, STD_BATCH_GENERIC),
                       stash_cols, sorted_form, sms)


@functools.lru_cache(maxsize=256)
def quot_plan(n: int, ways: int, stash_cols: int, q12: bool,
              sorted_form: bool, sms: int) -> LookupPlan:
    """K2's launch for n probes of a q8 (or ``q12``) table of ``ways``
    slots a row (:func:`lookup_plan`); the key lanes of the specialised
    body are read as 16-byte words, a group's loads of 2 rows issued
    together (the kernel's kBatch: 4 rows spilled and ran slower on every
    shape swept)."""
    if ways < 1:
        raise ValueError(f"ways={ways}")
    spec = ways if ways == QUOT_SPECS[bool(q12)] else 0
    return lookup_plan(n, spec, 2, stash_cols, sorted_form, sms)


def _quot_tail(dev, hi, fused, stash, ways: int, q12: bool, order,
               plan: LookupPlan | None) -> tuple:
    """K2's plan arguments: ``plan``, else :func:`quot_plan`'s, with the
    specialised body only where the table's rows start on 16 bytes."""
    if plan is None:
        plan = quot_plan(hi.numel(), ways, stash.shape[1], q12,
                         order is not None, _build.sm_count(dev.index))
    aligned = fused.data_ptr() % 16 == 0 and fused.shape[1] % 4 == 0
    return (plan.grid, plan.warps, plan.batch, plan.spec if aligned else 0,
            plan.l2, plan.smem)


def _std_kernel(dev, hi, lo, valid, fused, stash, ways: int, order, owner,
                plan: LookupPlan | None = None):
    """K4 on CUDA tensors; K9's order selects its sorted form, owner
    (n_shards, shard_id) its owner mask, and ``plan`` overrides
    :func:`std_plan` (kernels.lookup_sweep)."""
    _build.check(hi, torch.int32, name="hi")
    _build.check(lo, torch.int32, shape=hi.shape, name="lo")
    _build.check(valid, torch.bool, shape=hi.shape, name="valid")
    _build.check(fused, torch.int32, ndim=2, name="fused")
    _build.check(stash, torch.int32, ndim=2, name="stash")
    packed = _std_geometry(fused, ways)
    shift, shard_id = _owner_shift(owner)
    if stash.shape[0] != STASH_ROWS:
        raise ValueError(f"stash {tuple(stash.shape)} is not [5, S]")
    if plan is None:
        plan = std_plan(hi.numel(), ways, stash.shape[1], order is not None,
                        _build.sm_count(dev.index))
    # The specialised bodies read 8 or 16 bytes at once from the table.
    spec = plan.spec if fused.data_ptr() % 16 == 0 else 0
    return _launch_lookup(
        "pangea_lookup_std", dev, hi, order, hi.data_ptr(), lo.data_ptr(),
        valid.data_ptr(), hi.numel(), fused.data_ptr(), fused.shape[0], ways,
        int(packed), stash.data_ptr(), stash.shape[1], shift, shard_id,
        tail=(plan.grid, plan.warps, plan.batch, spec, plan.l2, plan.smem))
