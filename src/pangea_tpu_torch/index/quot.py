"""The quotient table layouts of an index, numpy only.

The port's copy of the reference's q8 and q12 table builders and sizing
(``pangea_tpu/kernels/lookup.py`` ``q8_hash_np``, ``q8_rem_bits``,
``q8_nb_for``, ``q12_nb_for``, ``q8_layout``, ``_q12_row_lanes``,
``_q12_split_np``, ``q12_layout``, ``_bucket_rank``); ``shard.py`` lays an
index's shards out with them. ``tests/test_torch_quot.py`` and
``tests/test_torch_q12.py`` hold them byte-identical to the reference.

q8 (SEMANTICS.md §5): the canonical k-mer K (2k bits) is mixed by the
bijection h = K·A mod 2^(2k); bucket = the top log2(NB) bits of h, rem =
the low r = 2k − log2(NB) ≤ 31 bits. A row holds W rem lanes (empty =
0xFFFFFFFF) then W payload lanes (tin << 16 | tout of the k-mer's taxon).
Bucket overflow goes to a full-key stash in ascending canonical order; a
stash above ``stash_max`` doubles NB and restarts.

q12 (the k=31 lane, where r = 2k − log2(NB) exceeds 31): the same mix and
split, with the remainder in two lanes. A row holds W = 42 rem_lo lanes (the
low 32 remainder bits), W rem_hi lanes (the rest; empty = 0xFFFFFFFF, which
no real rem_hi reaches), W payload lanes and 2 pad lanes: 128 lanes, 512 B.
"""
from __future__ import annotations

import numpy as np

from .container import EMPTY_HI

Q8_A = np.uint64(0x9E3779B1)          # odd multiplier of the bijective mix
Q8_WAYS = 64                          # 8 B x 64 = 512 B fused rows
Q12_WAYS = 42                         # 42 slots x 3 lanes + pad = 512 B


def q8_hash_np(canon: np.ndarray, k: int) -> np.ndarray:
    """h = (K * A) mod 2^(2k)."""
    mask = np.uint64((1 << (2 * k)) - 1)
    return (canon.astype(np.uint64) * Q8_A) & mask


def q8_rem_bits(k: int, nb: int) -> int:
    return 2 * k - (nb.bit_length() - 1)


def _capacity_nb(n: int, ways: int, load_factor: float) -> int:
    """The smallest power of two >= 8 buckets that holds n keys at the
    load factor."""
    nb = 8
    while nb * ways * load_factor < max(n, 1):
        nb *= 2
    return nb


def q8_nb_for(n: int, k: int, ways: int = Q8_WAYS,
              load_factor: float = 0.5, min_nb: int = 0) -> int | None:
    """The bucket count q8_layout's growth rule picks for n keys: capacity
    growth, then the min_nb floor, then rem-width growth. None when the
    remainder cannot fit 31 bits."""
    nb = _capacity_nb(n, ways, load_factor)
    while nb < min_nb:
        nb *= 2
    while q8_rem_bits(k, nb) > 31 and nb <= (1 << 26):
        nb *= 2
    return None if q8_rem_bits(k, nb) > 31 else nb


def q12_nb_for(n: int, k: int, ways: int = Q12_WAYS,
               load_factor: float = 0.5, min_nb: int = 0) -> int:
    """q12 bucket count: capacity growth and the min_nb floor only (the
    two-lane remainder always fits)."""
    nb = _capacity_nb(n, ways, load_factor)
    while nb < min_nb:
        nb *= 2
    return nb


def _bucket_rank(b, n: int, ways: int):
    """Within-bucket rank of each key (keys in ascending canonical order)
    and the placed/overflow split. Returns (order, bs, rank, place)."""
    order = np.argsort(b, kind="stable")
    bs = b[order]
    newgrp = np.concatenate([[True], bs[1:] != bs[:-1]]) if n else \
        np.zeros(0, bool)
    grp = np.cumsum(newgrp) - 1 if n else np.zeros(0, np.int64)
    first = np.flatnonzero(newgrp)
    rank = np.arange(n) - first[grp] if n else np.zeros(0, np.int64)
    return order, bs, rank, rank < ways


def q8_layout(kmers, taxa, tin, tout, k: int, ways: int = Q8_WAYS,
              load_factor: float = 0.5, stash_max: int = 128,
              min_nb: int = 0):
    """Lay (kmer -> taxon) pairs out as the q8 table.

    Returns (fused uint32 [NB, 2W], stash uint32 [3, S] rows (hi, lo,
    val-bits), nb), or None when the remainder would exceed 31 bits or the
    Euler stamps exceed 16 bits."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    taxa = np.asarray(taxa, dtype=np.int32)
    tin = np.asarray(tin, dtype=np.int32)
    tout = np.asarray(tout, dtype=np.int32)
    if int(tout.max(initial=0)) > 0xFFFF:
        return None
    n = kmers.shape[0]
    if n > 1 and not (kmers[1:] > kmers[:-1]).all():
        order = np.argsort(kmers, kind="stable")
        kmers, taxa = kmers[order], taxa[order]
    h = q8_hash_np(kmers, k)
    nb = q8_nb_for(n, k, ways, load_factor, min_nb)
    if nb is None:
        return None
    while True:
        r = q8_rem_bits(k, nb)
        if r > 31:
            return None
        if r < 0:
            nb = 1 << (2 * k)      # more buckets than k-mer values: clamp
            r = 0
        b = (h >> np.uint64(r)).astype(np.int64)
        rem = (h & np.uint64((1 << r) - 1)).astype(np.uint32)
        order, bs, rank, place = _bucket_rank(b, n, ways)
        over = np.sort(order[~place])           # ascending canonical
        if over.size > stash_max and r > 0:
            nb *= 2
            continue
        fused = np.zeros((nb, 2 * ways), dtype=np.uint32)
        fused[:, :ways] = EMPTY_HI              # empty rem sentinel
        ks = order[place]
        val = taxa[ks]
        pk = (tin[val].astype(np.uint32) << np.uint32(16)) \
            | tout[val].astype(np.uint32)
        fused[bs[place], rank[place]] = rem[ks]
        fused[bs[place], ways + rank[place]] = pk
        if over.size:
            stash = np.stack([
                (kmers[over] >> np.uint64(32)).astype(np.uint32),
                (kmers[over] & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                taxa[over].view(np.uint32)])
        else:
            stash = np.zeros((3, 0), dtype=np.uint32)
        return fused, stash, nb


def _q12_row_lanes(ways: int) -> int:
    """Lanes of a q12 row: the next power of two >= 3 * ways."""
    return 1 << (3 * ways - 1).bit_length()


def _q12_split_np(h: np.ndarray, r: int):
    """(bucket int64, rem_lo uint32, rem_hi uint32) of the q8 mix h."""
    b = (h >> np.uint64(r)).astype(np.int64)
    rem_lo = (h & np.uint64((1 << min(r, 32)) - 1)).astype(np.uint32)
    if r > 32:
        rem_hi = ((h >> np.uint64(32)) & np.uint64((1 << (r - 32)) - 1)
                  ).astype(np.uint32)
    else:
        rem_hi = np.zeros(h.shape, np.uint32)
    return b, rem_lo, rem_hi


def q12_layout(kmers, taxa, tin, tout, k: int, ways: int = Q12_WAYS,
               load_factor: float = 0.5, stash_max: int = 128,
               min_nb: int = 0):
    """Lay (kmer -> taxon) pairs out as the q12 table.

    Returns (fused uint32 [NB, RL] — lanes [0, W) rem_lo, [W, 2W) rem_hi,
    [2W, 3W) pk, [3W, RL) pad — stash uint32 [3, S] rows (hi, lo,
    val-bits), nb), or None when the Euler stamps exceed 16 bits. The
    placement rule is q8_layout's; a stash overflow doubles NB and
    restarts."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    taxa = np.asarray(taxa, dtype=np.int32)
    tin = np.asarray(tin, dtype=np.int32)
    tout = np.asarray(tout, dtype=np.int32)
    if int(tout.max(initial=0)) > 0xFFFF:
        return None
    n = kmers.shape[0]
    if n > 1 and not (kmers[1:] > kmers[:-1]).all():
        order = np.argsort(kmers, kind="stable")
        kmers, taxa = kmers[order], taxa[order]
    h = q8_hash_np(kmers, k)
    nb = q12_nb_for(n, k, ways, load_factor, min_nb)
    while True:
        r = q8_rem_bits(k, nb)
        if r < 0:
            nb = 1 << (2 * k)      # more buckets than k-mer values: clamp
            r = 0
        b, rem_lo, rem_hi = _q12_split_np(h, r)
        order, bs, rank, place = _bucket_rank(b, n, ways)
        over = np.sort(order[~place])           # ascending canonical
        if over.size > stash_max and r > 0:
            nb *= 2
            continue
        fused = np.zeros((nb, _q12_row_lanes(ways)), dtype=np.uint32)
        fused[:, ways:2 * ways] = EMPTY_HI      # empty rem_hi sentinel
        ks = order[place]
        val = taxa[ks]
        pk = (tin[val].astype(np.uint32) << np.uint32(16)) \
            | tout[val].astype(np.uint32)
        fused[bs[place], rank[place]] = rem_lo[ks]
        fused[bs[place], ways + rank[place]] = rem_hi[ks]
        fused[bs[place], 2 * ways + rank[place]] = pk
        if over.size:
            stash = np.stack([
                (kmers[over] >> np.uint64(32)).astype(np.uint32),
                (kmers[over] & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                taxa[over].view(np.uint32)])
        else:
            stash = np.zeros((3, 0), dtype=np.uint32)
        return fused, stash, nb
