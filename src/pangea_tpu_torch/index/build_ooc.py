"""The out-of-core index builder, numpy only.

The port's copy of ``pangea_tpu/index/build_ooc.py`` ``build_index_ooc``: a
reference set too large to hold every genome's k-mers in RAM (driver
configs 3 and 5) is built in two phases, with RAM bounded by one shard:

- spill: each genome's distinct canonical k-mers go, as (k-mer, taxon)
  records, to one of S * P partition files chosen by the top log2(S * P)
  hash bits. These bits begin with the owner bits, so a partition belongs
  to one shard and every copy of a k-mer lands in the same partition.
- reduce: a shard's partitions are read one at a time, sorted and folded
  to the LCA of their taxa (``build.dedupe_lca``); the shard's table is
  laid out by the monolithic rule and written to the sharded container.

For the same genomes the output equals ``build_index`` + ``shard_tables``,
and the files equal the reference builder's, byte for byte.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from .. import SEMANTICS_VERSION
from ..core import hash32_np
from ..taxonomy import Taxonomy
from .build import WAYS, _kmers_of_genome, dedupe_lca, layout_table
from .container import EMPTY_HI
from .sharded import ShardedIndex, ShardedIndexMeta, save_meta, save_shard

_REC = np.dtype([("k", "<u8"), ("t", "<i4")])


class _Spiller:
    """Append-only partition files, buffered in RAM up to buffer_bytes
    across all partitions, then flushed in partition order."""

    def __init__(self, spill_dir: str, n_parts: int,
                 buffer_bytes: int = 256 << 20):
        self.n_parts = n_parts
        self.buffer_bytes = buffer_bytes
        self.bufs: list[list[np.ndarray]] = [[] for _ in range(n_parts)]
        self.pending = 0
        self.paths = [os.path.join(spill_dir, f"part{p:04d}.bin")
                      for p in range(n_parts)]
        for p in self.paths:                       # truncate stale spills
            open(p, "wb").close()

    def add(self, part: np.ndarray, rec: np.ndarray) -> None:
        """rec: _REC records sorted by their partition ``part``."""
        bounds = np.searchsorted(part, np.arange(self.n_parts + 1))
        for p in range(self.n_parts):
            lo, hi = bounds[p], bounds[p + 1]
            if hi > lo:
                self.bufs[p].append(rec[lo:hi])
        self.pending += rec.nbytes
        if self.pending >= self.buffer_bytes:
            self.flush()

    def flush(self) -> None:
        for p, chunks in enumerate(self.bufs):
            if chunks:
                with open(self.paths[p], "ab") as fh:
                    for c in chunks:
                        fh.write(c.tobytes())
                self.bufs[p] = []
        self.pending = 0

    def read_part(self, p: int) -> np.ndarray:
        return np.fromfile(self.paths[p], dtype=_REC)

    def drop_part(self, p: int) -> None:
        os.unlink(self.paths[p])


def build_index_ooc(genomes, taxonomy: Taxonomy, k: int, out: str,
                    w: int = 1, n_shards: int = 8, parts_per_shard: int = 8,
                    load_factor: float = 0.5, spill_dir: str | None = None,
                    spill_buffer_mb: int = 256, ways: int = WAYS,
                    progress=None) -> ShardedIndex:
    """Build a sharded index directory ``out`` from (codes, taxon) genome
    pairs. n_shards and parts_per_shard are powers of two; the spill files
    go to spill_dir (kept), or to a temporary directory beside out
    (removed). RAM peaks near 3x the largest shard's record bytes plus one
    shard's table."""
    if k % 2 == 0 or not (1 <= k <= 31):
        raise ValueError("k must be odd and 1..31 (SEMANTICS.md §2)")
    for name, v in (("n_shards", n_shards),
                    ("parts_per_shard", parts_per_shard)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"{name} must be a power of two")
    P = n_shards * parts_per_shard
    log2P = P.bit_length() - 1
    os.makedirs(out, exist_ok=True)
    tmp = spill_dir or tempfile.mkdtemp(prefix="pangea_spill_",
                                        dir=os.path.dirname(out) or ".")
    os.makedirs(tmp, exist_ok=True)
    spiller = _Spiller(tmp, P, buffer_bytes=spill_buffer_mb << 20)
    try:
        n_genomes = 0
        for codes, taxon in genomes:                   # phase 1: spill
            km = _kmers_of_genome(np.asarray(codes, dtype=np.uint8), k, w)
            rec = np.empty(km.shape[0], dtype=_REC)
            rec["k"] = km
            rec["t"] = np.int32(int(taxon))
            if P > 1:
                part = (hash32_np(km) >> np.uint32(32 - log2P)) \
                    .astype(np.int32)
                order = np.argsort(part, kind="stable")
                spiller.add(part[order], rec[order])
            else:
                spiller.add(np.zeros(km.shape[0], np.int32), rec)
            n_genomes += 1
            if progress and n_genomes % 64 == 0:
                progress(f"spill: {n_genomes} genomes")
        spiller.flush()

        shard_buckets, shard_stash = [], []            # phase 2: reduce
        n_kmers = 0
        for s in range(n_shards):
            uks, uts = [], []
            for p in range(s * parts_per_shard, (s + 1) * parts_per_shard):
                rec = spiller.read_part(p)
                uk, ut = dedupe_lca(rec["k"].copy(), rec["t"].copy(),
                                    taxonomy)
                del rec
                uks.append(uk)
                uts.append(ut)
                spiller.drop_part(p)
            uk = np.concatenate(uks) if uks else np.zeros(0, np.uint64)
            ut = np.concatenate(uts) if uts else np.zeros(0, np.int32)
            del uks, uts
            order = np.argsort(uk, kind="stable")
            key_hi, key_lo, val, stash, nb = layout_table(
                uk[order], ut[order], load_factor, ways=ways)
            del uk, ut, order
            save_shard(out, s, key_hi, key_lo, val, stash)
            shard_buckets.append(nb)
            shard_stash.append(int(stash.shape[1]))
            n_kmers += int((key_hi != EMPTY_HI).sum() + stash.shape[1])
            if progress:
                progress(f"shard {s}: {nb} buckets, "
                         f"stash {stash.shape[1]}")
            del key_hi, key_lo, val, stash
    finally:
        if spill_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    meta = ShardedIndexMeta(
        k=k, w=w, ways=ways, n_shards=n_shards, n_kmers=n_kmers,
        shard_buckets=shard_buckets, shard_stash=shard_stash,
        taxonomy_hash=taxonomy.content_hash(),
        semantics_version=SEMANTICS_VERSION)
    save_meta(out, meta, taxonomy)
    return ShardedIndex.load(out)
