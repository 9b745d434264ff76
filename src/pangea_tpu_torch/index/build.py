"""Offline index builder and the device-layout policy, numpy only.

The port's copy of ``pangea_tpu/index/build.py``: scan reference genomes,
extract canonical k-mers (optionally minimizer-subsampled), LCA-merge
duplicates across taxa, and lay the result out as the single-probe
bucketized table of SEMANTICS.md §5 — NB buckets × W ways plus an overflow
stash — inserting in ascending canonical-k-mer order. The layout policy
:func:`pick_layout` and its gates decide which device table (q8, q12 or
std) a classify run builds from an index; the thresholds are the
reference's, so both packages choose alike. ``tests/test_torch_host.py``
holds the built arrays byte-equal to the reference's and the policy equal
over a grid.
"""
from __future__ import annotations

import numpy as np

from .. import SEMANTICS_VERSION
from ..core import canonical_kmers, hash32_np, minimizer_mask
from ..taxonomy import Taxonomy
from .container import EMPTY_HI, Index, IndexMeta
from .quot import Q8_WAYS, Q12_WAYS, q8_nb_for, q12_nb_for


def _kmers_of_genome(codes: np.ndarray, k: int, w: int) -> np.ndarray:
    """Distinct canonical k-mers (uint64) of one genome sequence."""
    canon, valid = canonical_kmers(codes, k)
    if w > 1:
        sel = minimizer_mask(canon, valid, w)
    else:
        sel = valid
    return np.unique(canon[sel])


def aggregate_kmers(genomes, k: int, w: int, taxonomy: Taxonomy,
                    progress=None):
    """genomes: iterable of (codes: uint8[], taxon: int).

    Returns (kmers: uint64[N] ascending, taxa: int32[N]) where taxa[i] is the
    LCA of all source taxa containing kmers[i] (SEMANTICS.md §5).
    """
    all_k: list[np.ndarray] = []
    all_t: list[np.ndarray] = []
    for n, (codes, taxon) in enumerate(genomes):
        km = _kmers_of_genome(np.asarray(codes, dtype=np.uint8), k, w)
        all_k.append(km)
        all_t.append(np.full(km.shape, int(taxon), dtype=np.int32))
        if progress and (n + 1) % 64 == 0:
            progress(n + 1)
    if not all_k:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    kmers = np.concatenate(all_k)
    taxa = np.concatenate(all_t)
    return dedupe_lca(kmers, taxa, taxonomy)


def dedupe_lca(kmers: np.ndarray, taxa: np.ndarray, taxonomy: Taxonomy):
    """Sort (kmer, taxon) pairs by k-mer and collapse duplicate k-mers to the
    LCA of their source taxa (each group sorted by Euler tin, so one
    pairwise LCA a group). Returns (kmers uint64[N] ascending unique,
    taxa int32[N])."""
    if kmers.shape[0] == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    order = np.lexsort((taxonomy.tin[taxa], kmers))
    kmers = kmers[order]
    taxa = taxa[order]
    new = np.concatenate([[True], kmers[1:] != kmers[:-1]])
    starts = np.flatnonzero(new)
    ends = np.concatenate([starts[1:], [kmers.shape[0]]])
    uk = kmers[starts]
    ut = taxa[starts].copy()
    multi = np.flatnonzero((ends - starts) > 1)
    if multi.size:
        ut[multi] = taxonomy.lca_segments(taxa, starts[multi], ends[multi])
    return uk, ut


WAYS = 16        # default bucket width: a 256 B packed device row
STASH_MAX = 128  # overflow cap; exceeding it doubles NB and restarts

# The reference's fast-gather regime bounds (rows, bytes). The layout
# policy below keys on them, so they stay as they are for the two packages
# to choose the same layout; they are TPU measurements, not H100 ones.
FAST_ROWS = 1 << 17
FAST_BYTES = 68 << 20


def _est_table(n: int, ways: int, load_factor: float):
    nb = 8
    while nb * ways * load_factor < max(n, 1):
        nb *= 2
    return nb, nb * ways * 16              # fused row = 16 B/slot


def _fits_fast(n: int, ways: int, load_factor: float = 0.5) -> bool:
    nb, by = _est_table(n, ways, load_factor)
    return nb <= FAST_ROWS and by <= FAST_BYTES


def _q8_sane_nb(n: int, k: int, ways: int,
                load_factor: float = 0.5) -> int | None:
    """q8 bucket count when exactness is reachable without absurd
    oversizing (the rem-width growth loop can inflate NB far past what
    capacity asks for at k ≥ 23); None in the pathological case."""
    nb_cap = 8
    while nb_cap * ways * load_factor < max(n, 1):
        nb_cap *= 2
    nb = q8_nb_for(n, k, ways, load_factor)
    if nb is None or (nb > 2 * nb_cap and nb > FAST_ROWS):
        return None
    return nb


def q8_plan_sharded(n_kmers: int, n_shards: int, k: int, tout_max: int,
                    load_factor: float = 0.5, ways: int = 64) -> int | None:
    """Eligibility of the per-shard q8 relayout: the per-shard bucket
    count, or None. Needs rem ≤ 31 bits without absurd NB inflation and
    16-bit Euler stamps."""
    if tout_max > 0xFFFF:
        return None
    per = -(-max(n_kmers, 1) // max(n_shards, 1))
    return _q8_sane_nb(per, k, ways, load_factor)


def q12_plan(n_kmers: int, n_shards: int, k: int, tout_max: int,
             load_factor: float = 0.5, ways: int = 0) -> int | None:
    """Eligibility of the q12 two-lane-remainder layout: q8 cannot reach
    exactness sanely, the std table would not fit the fast regime at W=16
    or W=32, and the Euler stamps fit 16 bits. The bucket count, or None."""
    if tout_max > 0xFFFF:
        return None
    per = -(-max(n_kmers, 1) // max(n_shards, 1))
    if _q8_sane_nb(per, k, Q8_WAYS, load_factor) is not None:
        return None
    if _fits_fast(per, 16, load_factor) or _fits_fast(per, 32,
                                                      load_factor):
        return None
    return q12_nb_for(per, k, ways or Q12_WAYS, load_factor)


def pick_layout(n_kmers: int, n_shards: int, k: int, tout_max: int, *,
                requested: str = "auto", no_sub: bool = True,
                q8_ways: int = 64, q12_ways: int = 0) -> str:
    """The device-layout decision: "std" | "q8" | "q12".

    Explicit requests are gated on exactness only; "auto" takes q8
    wherever its exactness is reachable sanely, then q12 for the k=31
    family, then std. Raises ValueError for an unknown or
    exactness-impossible request."""
    if requested not in ("std", "q8", "q12", "auto"):
        raise ValueError(f"unknown layout {requested!r}")
    if requested in ("q8", "q12") and not no_sub:
        raise ValueError(f"{requested} layout is incompatible with "
                         "n_sub > 1 / PANGEA_NSUB")
    per = -(-max(n_kmers, 1) // max(n_shards, 1))
    if requested == "q8":
        if tout_max > 0xFFFF or q8_nb_for(per, k, q8_ways) is None:
            raise ValueError(
                "q8 layout requested but exactness is unreachable: "
                "rem > 31 bits at the capped bucket count (k=31 — use "
                "q12) or Euler stamps > 16 bits")
        return "q8"
    if requested == "q12":
        if tout_max > 0xFFFF:
            raise ValueError("q12 layout requested but Euler stamps "
                             "exceed 16 bits")
        return "q12"
    if requested == "std" or not no_sub:
        return "std"
    if q8_plan_sharded(n_kmers, n_shards, k, tout_max,
                       ways=q8_ways) is not None:
        return "q8"
    if q12_plan(n_kmers, n_shards, k, tout_max,
                ways=q12_ways) is not None:
        return "q12"
    return "std"


def auto_ways(n_kmers: int, load_factor: float = 0.5) -> int:
    """Auto bucket width (build side): the smallest W ∈ {16, 32} that keeps
    the table within the fast-regime bounds, else 16."""
    for ways in (16, 32):
        if _fits_fast(n_kmers, ways, load_factor):
            return ways
    return WAYS


def bucket_of_np(kmers: np.ndarray, nb: int) -> np.ndarray:
    """The single candidate bucket per SEMANTICS.md §4: h & (NB-1)."""
    return (hash32_np(kmers) & np.uint32(nb - 1)).astype(np.int64)


def layout_table(kmers: np.ndarray, taxa: np.ndarray,
                 load_factor: float = 0.5, ways: int = WAYS):
    """Place (kmer → taxon) pairs into the single-probe bucketized table
    (SEMANTICS.md §5): ascending canonical k-mers claim free lanes of
    their bucket in ascending lane order; bucket overflow goes to the stash
    in ascending canonical order. If the stash would exceed STASH_MAX, NB
    doubles and the layout restarts.

    Returns (key_hi [NB, W], key_lo [NB, W], val [NB, W],
    stash [3, n_stash] uint32 rows (hi, lo, val-bits), n_buckets).
    """
    kmers = np.asarray(kmers, dtype=np.uint64)
    taxa = np.asarray(taxa, dtype=np.int32)
    n = kmers.shape[0]
    if n > 1 and not (kmers[1:] > kmers[:-1]).all():
        order = np.argsort(kmers, kind="stable")
        kmers, taxa = kmers[order], taxa[order]
    hi = (kmers >> np.uint64(32)).astype(np.uint32)
    lo = (kmers & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    nb = 8
    while nb * ways * load_factor < max(n, 1):
        nb *= 2
    while True:
        out = _try_layout(hi, lo, taxa, kmers, nb, ways)
        if out is not None:
            key_hi, key_lo, val, stash = out
            return key_hi, key_lo, val, stash, nb
        nb *= 2  # SEMANTICS.md §5 step 3


def _try_layout(hi, lo, taxa, kmers, nb, ways=WAYS):
    n = kmers.shape[0]
    key_hi = np.full((nb, ways), EMPTY_HI, dtype=np.uint32)
    key_lo = np.zeros((nb, ways), dtype=np.uint32)
    val = np.zeros((nb, ways), dtype=np.int32)
    b = bucket_of_np(kmers, nb)
    # kmers ascending ⇒ within a bucket, contenders appear in ascending
    # canonical order; rank = position within its bucket group.
    order = np.argsort(b, kind="stable")
    bs = b[order]
    newgrp = np.concatenate([[True], bs[1:] != bs[:-1]]) if n else \
        np.zeros(0, bool)
    grp = np.cumsum(newgrp) - 1 if n else np.zeros(0, np.int64)
    first = np.flatnonzero(newgrp)
    rank = np.arange(n) - first[grp] if n else np.zeros(0, np.int64)
    place = rank < ways
    ks = order[place]
    key_hi[bs[place], rank[place]] = hi[ks]
    key_lo[bs[place], rank[place]] = lo[ks]
    val[bs[place], rank[place]] = taxa[ks]
    over = np.sort(order[~place])  # ascending canonical order
    if over.size > STASH_MAX:
        return None
    stash = np.stack([hi[over], lo[over],
                      taxa[over].view(np.uint32)]) if over.size else \
        np.zeros((3, 0), dtype=np.uint32)
    return key_hi, key_lo, val, stash.astype(np.uint32)


def build_index(genomes, taxonomy: Taxonomy, k: int, w: int = 1,
                load_factor: float = 0.5, progress=None,
                ways: int = WAYS) -> Index:
    """Build an :class:`Index` from (codes, taxon) genome pairs.

    ways: bucket width (fused device row = 16·ways bytes packed, 24·ways
    wide); 0 = auto (:func:`auto_ways`)."""
    if k % 2 == 0 or not (1 <= k <= 31):
        raise ValueError("k must be odd and 1..31 (SEMANTICS.md §2)")
    uk, ut = aggregate_kmers(genomes, k, w, taxonomy, progress=progress)
    if ways == 0:
        ways = auto_ways(int(uk.shape[0]), load_factor)
    key_hi, key_lo, val, stash, nb = layout_table(uk, ut, load_factor,
                                                  ways=ways)
    meta = IndexMeta(
        k=k, w=w, n_buckets=nb, ways=ways,
        n_kmers=int(uk.shape[0]),
        n_stash=int(stash.shape[1]),
        taxonomy_hash=taxonomy.content_hash(),
        semantics_version=SEMANTICS_VERSION,
    )
    return Index(meta, key_hi, key_lo, val, taxonomy, stash=stash)
