"""The sharded on-disk index container, numpy only.

The port's copy of ``pangea_tpu/index/sharded.py``. An index too large to
lay out in RAM (driver configs 3 and 5) is written by the out-of-core
builder as one single-probe table a hash-range shard (the owner rule: the
top log2 S bits of the k-mer's hash), each laid out by the monolithic rule
over its own k-mers::

    meta.json            k, w, ways, n_shards, per-shard bucket/stash counts
    taxonomy.npz
    shard000/key_hi.npy  uint32[NB_s, W]   (np.load mmap-able)
    shard000/key_lo.npy  uint32[NB_s, W]
    shard000/val.npy     int32[NB_s, W]
    shard000/stash.npy   uint32[3, S_s]
    shard001/...

The format is the reference's, so either package loads what the other
wrote. For the same k-mers, ``ShardedIndex.shard_tables(n)`` equals
``shard.shard_tables(monolithic_index, n)`` at any n.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field

import numpy as np

from ..taxonomy import Taxonomy
from .build import bucket_of_np
from .container import FORMAT_VERSION

SHARD_FILES = ("key_hi", "key_lo", "val", "stash")


@dataclass
class ShardedIndexMeta:
    k: int
    w: int
    ways: int
    n_shards: int
    n_kmers: int
    shard_buckets: list    # per-shard NB (powers of two)
    shard_stash: list      # per-shard stash sizes
    taxonomy_hash: str
    semantics_version: int
    format_version: int = FORMAT_VERSION
    sharded: bool = field(default=True)   # tells the meta.json kinds apart


def _shard_dir(path: str, s: int) -> str:
    return os.path.join(path, f"shard{s:03d}")


def _load_shard(path: str, s: int, mode):
    d = _shard_dir(path, s)
    return tuple(np.load(os.path.join(d, f"{n}.npy"), mmap_mode=mode)
                 for n in SHARD_FILES)


class ShardedIndex:
    """A k-mer -> taxon index stored as per-hash-range shard tables."""

    def __init__(self, meta: ShardedIndexMeta, shards: list, taxonomy,
                 path: str | None = None):
        self.meta = meta
        self.shards = shards      # [(key_hi, key_lo, val, stash)] a shard
        self.taxonomy = taxonomy
        self.path = path          # set by load(): placement re-maps shards

    def open_shard(self, s: int):
        """(key_hi, key_lo, val, stash) of one shard as fresh mmaps, unmapped
        when the caller drops them, so that a placement touches about one
        shard's file pages at a time."""
        if self.path is None:
            return self.shards[s]
        return _load_shard(self.path, s, "r")

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "ShardedIndex":
        with open(os.path.join(path, "meta.json")) as fh:
            meta = ShardedIndexMeta(**json.load(fh))
        if meta.format_version != FORMAT_VERSION:
            raise ValueError(
                f"{path}: index format v{meta.format_version} != "
                f"v{FORMAT_VERSION} — rebuild the index")
        mode = "r" if mmap else None
        shards = [_load_shard(path, s, mode) for s in range(meta.n_shards)]
        taxonomy = Taxonomy.load(os.path.join(path, "taxonomy.npz"))
        if meta.taxonomy_hash != taxonomy.content_hash():
            raise ValueError(f"{path}: taxonomy hash mismatch — index was "
                             "built against a different taxonomy")
        return cls(meta, shards, taxonomy, path=path)

    def shard_tables(self, n_shards: int, load_factor: float = 0.5):
        """Stacked std tables at n_shards (see shard.shard_tables). A
        matching count stacks the files as they are; a smaller one merges
        groups of adjacent file shards and a larger one splits each file
        shard by the next hash bits (the owner bits nest), re-laying only
        shard-sized pieces."""
        from .build import layout_table
        from .shard import extract_pairs_tables, owner_of, stack_parts
        S = self.meta.n_shards
        ways = self.meta.ways
        if n_shards == S:
            return stack_parts([(khi, klo, v, st, khi.shape[0])
                                for (khi, klo, v, st) in self.shards])
        parts = []
        if n_shards < S:          # merge groups of r adjacent file shards
            r = S // n_shards
            for m in range(n_shards):
                pairs = [extract_pairs_tables(*self.shards[s])
                         for s in range(m * r, (m + 1) * r)]
                canon = np.concatenate([c for c, _ in pairs])
                taxa = np.concatenate([t for _, t in pairs])
                order = np.argsort(canon, kind="stable")
                parts.append(layout_table(canon[order], taxa[order],
                                          load_factor, ways=ways))
            return stack_parts(parts)
        r = n_shards // S         # split each file shard r ways
        for s in range(S):
            canon, taxa = extract_pairs_tables(*self.shards[s])
            owner = owner_of(canon, n_shards)
            for m in range(s * r, (s + 1) * r):
                sel = owner == m
                parts.append(layout_table(canon[sel], taxa[sel], load_factor,
                                          ways=ways))
        return stack_parts(parts)

    def lookup_np(self, canon: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Host lookup (SEMANTICS.md §5, §5.1): each k-mer goes to its owner
        shard, whose bucket row and stash it is compared with; the taxon,
        or 0 for a miss or an invalid k-mer."""
        from .shard import owner_of
        canon = np.asarray(canon, dtype=np.uint64)
        out = np.zeros(canon.shape, dtype=np.int32)
        alive = np.asarray(valid, dtype=bool)
        owner = owner_of(canon, self.meta.n_shards)
        hi = (canon >> np.uint64(32)).astype(np.uint32)
        lo = (canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        for s, (khi, klo, v, st) in enumerate(self.shards):
            idx = np.flatnonzero(alive & (owner == s))
            if not idx.size:
                continue
            b = bucket_of_np(canon[idx], khi.shape[0])
            lane = (khi[b] == hi[idx, None]) & (klo[b] == lo[idx, None])
            hit = lane.any(axis=1)
            out[idx[hit]] = v[b[hit], np.argmax(lane[hit], axis=1)]
            if st.shape[1]:
                shit = (hi[idx, None] == st[0][None, :]) \
                    & (lo[idx, None] == st[1][None, :])
                sany = shit.any(axis=1)
                out[idx[sany]] = st[2].view(np.int32)[
                    np.argmax(shit[sany], axis=1)]
        return out

    @property
    def nbytes(self) -> int:
        return sum(khi.nbytes + klo.nbytes + v.nbytes + st.nbytes
                   for (khi, klo, v, st) in self.shards)

    def __repr__(self) -> str:
        m = self.meta
        return (f"ShardedIndex(k={m.k}, w={m.w}, shards={m.n_shards}, "
                f"kmers={m.n_kmers}, {self.nbytes/1e9:.2f} GB)")


def save_shard(path: str, s: int, key_hi, key_lo, val, stash) -> None:
    d = _shard_dir(path, s)
    os.makedirs(d, exist_ok=True)
    for name, arr in zip(SHARD_FILES, (key_hi, key_lo, val, stash)):
        np.save(os.path.join(d, f"{name}.npy"), arr)


def save_meta(path: str, meta: ShardedIndexMeta, taxonomy) -> None:
    taxonomy.save(os.path.join(path, "taxonomy.npz"))
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(asdict(meta), fh, indent=2, sort_keys=True)
