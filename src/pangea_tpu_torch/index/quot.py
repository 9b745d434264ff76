"""The q8 host relayout, numpy only.

A jax-free copy of the reference's q8 table builders
(``pangea_tpu/kernels/lookup.py`` ``q8_hash_np``, ``q8_rem_bits``,
``q8_nb_for``, ``q8_layout``, ``_bucket_rank``, ``fuse_stash``), of its
single-shard relayout (``pangea_tpu/index/shard.py`` ``shard_tables_quot``)
and of the q8 branch of its layout policy (``pangea_tpu/index/build.py``
``_q8_sane_nb``, ``q8_plan_sharded``, ``pick_layout``). The reference
modules reach ``jax`` when they are imported or called, so the port keeps
its own copy; ``tests/test_torch_quot.py`` holds it byte-identical to the
reference.

Layout (SEMANTICS.md §5, q8): the canonical k-mer K (2k bits) is mixed by
the bijection h = K·A mod 2^(2k); bucket = the top log2(NB) bits of h, rem
= the low r = 2k − log2(NB) ≤ 31 bits. A fused row holds W rem lanes
(empty = 0xFFFFFFFF) then W payload lanes (tin << 16 | tout of the k-mer's
taxon). Bucket overflow goes to a full-key stash in ascending canonical
order; a stash above ``stash_max`` doubles NB and restarts.
"""
from __future__ import annotations

import numpy as np

from pangea_tpu.index.build import FAST_ROWS
from pangea_tpu.index.container import EMPTY_HI
from pangea_tpu.index.shard import extract_pairs, stack_q8_parts

Q8_A = np.uint64(0x9E3779B1)          # odd multiplier of the bijective mix
Q8_WAYS = 64                          # 8 B x 64 = 512 B fused rows


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


def fuse_stash(stash, tin, tout):
    """uint32 [3, S] (hi, lo, val-bits) -> uint32 [5, S] with the taxon's
    tin and tout appended as rows 3 and 4."""
    stash = np.asarray(stash, dtype=np.uint32)
    sval = stash[2].view(np.int32)
    tin = np.asarray(tin, dtype=np.int32)
    tout = np.asarray(tout, dtype=np.int32)
    return np.concatenate(
        [stash, tin[sval].view(np.uint32)[None, :],
         tout[sval].view(np.uint32)[None, :]], axis=0)


def relayout_q8(index, ways: int = Q8_WAYS, load_factor: float = 0.5):
    """One-shard q8 relayout of an index: the arrays of the reference's
    ``DeviceIndex._from_index_quot(index, 1, "q8", ...)``.

    Returns (fused uint32 [1, NB, 2W], stash uint32 [1, 5, S], nb), or
    None when the layout is ineligible."""
    tax = index.taxonomy
    if int(tax.tout.max(initial=0)) > 0xFFFF:
        return None
    k = index.meta.k
    canon, taxa = extract_pairs(index)
    nb = q8_nb_for(int(canon.shape[0]), k, ways, load_factor)
    if nb is None:
        return None
    while True:                     # a stash overflow can outgrow nb
        out = q8_layout(canon, taxa, tax.tin, tax.tout, k, ways=ways,
                        load_factor=load_factor, min_nb=nb)
        if out is None:
            return None
        fused, stash3, nb_s = out
        if nb_s <= nb:
            break
        nb = nb_s
    fused, stash3 = stack_q8_parts([(fused, stash3)])
    stash = fuse_stash(stash3[0], tax.tin, tax.tout)[None]
    return fused, stash, nb


def q8_gate(n_kmers: int, k: int, tout_max: int, ways: int = Q8_WAYS,
            load_factor: float = 0.5) -> str:
    """The reference's auto layout decision for one shard
    (``pick_layout(n_kmers, 1, k, tout_max)``), restricted to what the
    port runs: returns "q8", and raises NotImplementedError where the
    reference would choose another layout."""
    if tout_max > 0xFFFF:
        raise NotImplementedError(
            "Euler stamps above 16 bits need the std layout, which the "
            "port does not run yet (ROADMAP B8/B9)")
    nb_cap = _capacity_nb(n_kmers, ways, load_factor)
    nb = q8_nb_for(n_kmers, k, ways, load_factor)
    if nb is None or (nb > 2 * nb_cap and nb > FAST_ROWS):
        raise NotImplementedError(
            f"k={k} with {n_kmers} k-mers needs the q12 or std layout, "
            "which the port does not run yet (ROADMAP B10, B8/B9)")
    return "q8"
