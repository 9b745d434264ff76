"""Index container and its on-disk format, numpy only.

The port's copy of ``pangea_tpu/index/container.py``: a single-probe
bucketized table (SEMANTICS.md §5 — NB buckets × W ways) as three dense
arrays (``key_hi``/``key_lo`` uint32 [NB, W], ``val`` int32 [NB, W]) plus an
overflow ``stash`` (uint32 [3, S] rows hi/lo/val-bits). On disk an index is
a directory::

    meta.json      header: k, w, n_buckets, ways, counts, hashes
    key_hi.npy     uint32[NB, W]   (np.load mmap-able)
    key_lo.npy     uint32[NB, W]
    val.npy        int32[NB, W]
    stash.npy      uint32[3, n_stash]
    taxonomy.npz   the taxonomy the index was built against

The format is the reference's, so either package loads what the other
wrote. Empty lanes carry ``key_hi == EMPTY_HI`` (0xFFFFFFFF, unreachable
for valid k-mers with k ≤ 31).
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass

import numpy as np

from ..taxonomy import Taxonomy

EMPTY_HI = np.uint32(0xFFFFFFFF)
FORMAT_VERSION = 4


@dataclass
class IndexMeta:
    k: int
    w: int                  # minimizer window (1 = every k-mer)
    n_buckets: int          # NB (power of two)
    ways: int               # lanes per bucket
    n_kmers: int            # distinct k-mers stored
    n_stash: int            # overflow k-mers in the stash (≤ 128)
    taxonomy_hash: str
    semantics_version: int
    format_version: int = FORMAT_VERSION

    @property
    def size(self) -> int:
        """Total slots (NB × ways + stash)."""
        return self.n_buckets * self.ways + self.n_stash


class Index:
    """An immutable k-mer → taxon single-probe table + its taxonomy."""

    def __init__(self, meta: IndexMeta, key_hi, key_lo, val,
                 taxonomy: Taxonomy, stash=None):
        self.meta = meta
        self.key_hi = np.asarray(key_hi, dtype=np.uint32)
        self.key_lo = np.asarray(key_lo, dtype=np.uint32)
        self.val = np.asarray(val, dtype=np.int32)
        self.stash = (np.asarray(stash, dtype=np.uint32)
                      if stash is not None else np.zeros((3, 0), np.uint32))
        self.taxonomy = taxonomy

    def lookup_np(self, canon: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Host-side lookup (the golden model's). canon uint64 → taxon
        int32 (0 = miss), per SEMANTICS.md §5 v5: gather the bucket row,
        compare all its lanes, then scan the stash."""
        from .build import bucket_of_np
        canon = np.asarray(canon, dtype=np.uint64)
        hi = (canon >> np.uint64(32)).astype(np.uint32)
        lo = (canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        b = bucket_of_np(canon, self.meta.n_buckets)
        out = np.zeros(canon.shape, dtype=np.int32)
        idx = np.flatnonzero(np.asarray(valid, dtype=bool))
        hitlane = ((self.key_hi[b[idx]] == hi[idx, None])
                   & (self.key_lo[b[idx]] == lo[idx, None]))
        anyhit = hitlane.any(axis=1)
        lane = np.argmax(hitlane, axis=1)
        out[idx[anyhit]] = self.val[b[idx[anyhit]], lane[anyhit]]
        if self.stash.shape[1]:
            s_hi, s_lo, s_val = self.stash
            shit = (hi[idx, None] == s_hi[None, :]) \
                & (lo[idx, None] == s_lo[None, :])
            sany = shit.any(axis=1)
            sl = np.argmax(shit, axis=1)
            out[idx[sany]] = s_val.view(np.int32)[sl[sany]]
        return out

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(asdict(self.meta), fh, indent=2, sort_keys=True)
        np.save(os.path.join(path, "key_hi.npy"), self.key_hi)
        np.save(os.path.join(path, "key_lo.npy"), self.key_lo)
        np.save(os.path.join(path, "val.npy"), self.val)
        np.save(os.path.join(path, "stash.npy"), self.stash)
        self.taxonomy.save(os.path.join(path, "taxonomy.npz"))

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "Index":
        with open(os.path.join(path, "meta.json")) as fh:
            meta = IndexMeta(**json.load(fh))
        if meta.format_version != FORMAT_VERSION:
            raise ValueError(
                f"{path}: index format v{meta.format_version} != "
                f"v{FORMAT_VERSION} — rebuild the index")
        mode = "r" if mmap else None
        key_hi = np.load(os.path.join(path, "key_hi.npy"), mmap_mode=mode)
        key_lo = np.load(os.path.join(path, "key_lo.npy"), mmap_mode=mode)
        val = np.load(os.path.join(path, "val.npy"), mmap_mode=mode)
        stash = np.load(os.path.join(path, "stash.npy"))
        taxonomy = Taxonomy.load(os.path.join(path, "taxonomy.npz"))
        if meta.taxonomy_hash != taxonomy.content_hash():
            raise ValueError(f"{path}: taxonomy hash mismatch — index was "
                             "built against a different taxonomy")
        return cls(meta, key_hi, key_lo, val, taxonomy, stash=stash)

    @property
    def nbytes(self) -> int:
        return (self.key_hi.nbytes + self.key_lo.nbytes + self.val.nbytes
                + self.stash.nbytes)

    def __repr__(self) -> str:
        m = self.meta
        return (f"Index(k={m.k}, w={m.w}, slots={m.size}, kmers={m.n_kmers}, "
                f"stash={m.n_stash}, {self.nbytes/1e6:.1f} MB)")
