"""Index sharding and the device relayouts, numpy only.

The port's copy of ``pangea_tpu/index/shard.py``: an index's k-mer set split
into S per-shard single-probe tables by the top log2 S hash bits (the owner
rule, SEMANTICS.md §5.1), each laid out by the monolithic rule and stacked
[S, ...] at a common size. Resharding needs no genomes: the key set is
recovered from the table itself. Both sources the reference takes feed it:
a monolithic :class:`~.container.Index` (re-laid in RAM) and a
:class:`~.sharded.ShardedIndex` (the out-of-core builder's per-shard files;
only shards whose count differs from the wanted one are re-laid).

``relayout_q8``, ``relayout_q12`` and ``relayout_std`` are the one-shard
forms a single device places. ``tests/test_torch_shard.py``,
``tests/test_torch_quot.py`` and ``tests/test_torch_q12.py`` hold every
function byte-identical to the reference.
"""
from __future__ import annotations

import numpy as np

from ..core import hash32_np
from .build import layout_table
from .container import EMPTY_HI
from .quot import (Q8_WAYS, Q12_WAYS, q8_layout, q8_nb_for, q12_layout,
                   q12_nb_for)

# Sharded quotient stashes pad to the layouts' stash_max, a width every rank
# can compute alone.
STASH_PAD = 128
QUOT_LAYOUTS = {"q8": (q8_layout, q8_nb_for), "q12": (q12_layout, q12_nb_for)}


def extract_pairs_tables(key_hi, key_lo, val, stash):
    """Recover (canon uint64[N] ascending, taxon int32[N]) from raw table
    arrays (bucket rows + stash; padded stash columns excluded)."""
    occ = key_hi != np.uint32(EMPTY_HI)
    hi = key_hi[occ].astype(np.uint64)
    lo = key_lo[occ].astype(np.uint64)
    canon = (hi << np.uint64(32)) | lo
    taxa = np.asarray(val)[occ]
    if stash is not None and stash.shape[1]:
        s_hi, s_lo, s_val = stash
        s_real = s_hi != np.uint32(EMPTY_HI)
        canon = np.concatenate(
            [canon, (s_hi[s_real].astype(np.uint64) << np.uint64(32))
             | s_lo[s_real].astype(np.uint64)])
        taxa = np.concatenate([taxa, s_val.view(np.int32)[s_real]])
    order = np.argsort(canon, kind="stable")
    return canon[order], taxa[order]


def extract_pairs(index):
    """Recover (canon uint64[N] ascending, taxon int32[N]) from an
    :class:`Index` or a :class:`ShardedIndex` (per-shard extraction,
    merged ascending)."""
    if hasattr(index, "key_hi"):
        return extract_pairs_tables(index.key_hi, index.key_lo, index.val,
                                    index.stash)
    cs, ts = [], []
    for sh in index.shards:
        c, t = extract_pairs_tables(*sh)
        cs.append(c)
        ts.append(t)
    canon = np.concatenate(cs) if cs else np.zeros(0, np.uint64)
    taxa = np.concatenate(ts) if ts else np.zeros(0, np.int32)
    order = np.argsort(canon, kind="stable")
    return canon[order], taxa[order]


def owner_of(canon: np.ndarray, n_shards: int) -> np.ndarray:
    """The shard that owns each k-mer: the top log2(n_shards) hash bits.
    n_shards must be a power of two; 1 gives all zeros."""
    if n_shards == 1:
        return np.zeros(canon.shape, dtype=np.uint32)
    log2n = n_shards.bit_length() - 1
    return hash32_np(canon) >> np.uint32(32 - log2n)


def stack_parts(parts):
    """Pad per-shard std layouts (key_hi, key_lo, val, stash, nb) to a
    common power-of-two bucket count and stash width: [S, NB_max, W] x3 and
    stash [S, 3, max(S_max, 1)]. A shard's table is repeated NB_max / nb
    times, so bucket = hash & (NB_max - 1) lands on a copy of its row; stash
    padding carries EMPTY_HI keys, which never match."""
    nb_max = max(p[4] for p in parts)
    s_max = max(max(p[3].shape[1] for p in parts), 1)
    W = parts[0][0].shape[1]
    n = len(parts)
    key_hi = np.full((n, nb_max, W), EMPTY_HI, dtype=np.uint32)
    key_lo = np.zeros((n, nb_max, W), dtype=np.uint32)
    val = np.zeros((n, nb_max, W), dtype=np.int32)
    stash = np.zeros((n, 3, s_max), dtype=np.uint32)
    stash[:, 0, :] = EMPTY_HI
    for s, (khi, klo, v, st, nb) in enumerate(parts):
        reps = nb_max // nb
        key_hi[s] = np.tile(khi, (reps, 1))
        key_lo[s] = np.tile(klo, (reps, 1))
        val[s] = np.tile(v, (reps, 1))
        stash[s, :, :st.shape[1]] = st
    return key_hi, key_lo, val, stash


def pad_stash(stash3: np.ndarray, width: int) -> np.ndarray:
    """A [3, S] stash padded with EMPTY_HI columns to at least width."""
    if stash3.shape[1] >= width:
        return stash3
    pad = np.zeros((3, width - stash3.shape[1]), dtype=np.uint32)
    pad[0] = EMPTY_HI
    return np.concatenate([stash3, pad], axis=1)


def stack_q8_parts(parts, stash_pad: int = 0):
    """Stack per-shard quotient layouts ((fused [NB, RL], stash [3, S_s]),
    one common NB) into [S, NB, RL] and [S, 3, max(S_max, stash_pad)]."""
    s_max = max(max(p[1].shape[1] for p in parts), stash_pad)
    return (np.stack([p[0] for p in parts]),
            np.stack([pad_stash(p[1], s_max) for p in parts]))


def shard_tables_quot(index, n_shards: int, ways: int,
                      load_factor: float = 0.5, layout: str = "q8"):
    """Per-shard quotient relayout: the owner partition, each shard's keys
    laid out as its own q8 or q12 table at one common bucket count. A key
    is stored only in its owner shard, and (bucket, rem) <-> K is a
    bijection, so a probe can match only in its owner's table: the probe
    needs no owner mask and the shards' hits have disjoint support.

    Returns (fused uint32 [S, NB, RL], stash uint32 [S, 3, S_max], nb) or
    None when the layout is ineligible (q8: rem > 31 bits; Euler stamps >
    16 bits). Stashes pad to STASH_PAD columns when S > 1."""
    layout_fn, nb_fn = QUOT_LAYOUTS[layout]
    tax = index.taxonomy
    if int(tax.tout.max(initial=0)) > 0xFFFF:
        return None
    k = index.meta.k
    canon, taxa = extract_pairs(index)
    owner = owner_of(canon, n_shards)
    counts = np.bincount(owner.astype(np.int64), minlength=n_shards)
    nbs = [nb_fn(int(c), k, ways, load_factor) for c in counts]
    if not nbs or any(v is None for v in nbs):
        return None
    nb = max(nbs)
    while True:                     # rare: a shard outgrows the target nb
        parts = []
        for s in range(n_shards):
            m = owner == s
            out = layout_fn(canon[m], taxa[m], tax.tin, tax.tout, k,
                            ways=ways, load_factor=load_factor, min_nb=nb)
            if out is None:
                return None
            f, st, nb_s = out
            if nb_s > nb:
                nb = nb_s
                parts = None
                break
            parts.append((f, st))
        if parts is not None:
            break
    fused, stash = stack_q8_parts(
        parts, stash_pad=STASH_PAD if n_shards > 1 else 0)
    return fused, stash, nb


def shard_tables(index, n_shards: int, load_factor: float = 0.5):
    """(key_hi, key_lo, val, stash) stacked [S, NB_max, W] / stash
    [S, 3, S_max] at n_shards (a power of two), from an :class:`Index` or a
    :class:`ShardedIndex`."""
    if n_shards & (n_shards - 1):
        raise ValueError("n_shards must be a power of two")
    if hasattr(index, "shard_tables"):
        return index.shard_tables(n_shards, load_factor)
    canon, taxa = extract_pairs(index)
    owner = owner_of(canon, n_shards)
    return stack_parts([layout_table(canon[owner == s], taxa[owner == s],
                                     load_factor, ways=index.meta.ways)
                        for s in range(n_shards)])


def relayout_q8(index, ways: int = Q8_WAYS, load_factor: float = 0.5):
    """One-shard q8 relayout: (fused uint32 [1, NB, 2W], stash uint32
    [1, 3, S], nb), or None when the layout is ineligible."""
    return shard_tables_quot(index, 1, ways, load_factor, "q8")


def relayout_q12(index, ways: int = Q12_WAYS, load_factor: float = 0.5):
    """One-shard q12 relayout: (fused uint32 [1, NB, 128], stash uint32
    [1, 3, S], nb), or None when the Euler stamps exceed 16 bits."""
    return shard_tables_quot(index, 1, ways, load_factor, "q12")


def relayout_std(index, load_factor: float = 0.5):
    """One-shard std relayout, the pairs laid out again at
    ``index.meta.ways``: (key_hi, key_lo uint32 [1, NB, W], val int32
    [1, NB, W], stash uint32 [1, 3, max(S, 1)])."""
    return shard_tables(index, 1, load_factor)
