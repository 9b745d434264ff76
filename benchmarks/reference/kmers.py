"""Canonical k-mers, the table hash and minimizer selection
(SEMANTICS.md §1-§4), vectorized over whole sequences and batches."""
from __future__ import annotations

import numpy as np

M32 = np.uint64(0xFFFFFFFF)


def canonical_kmers(codes: np.ndarray, k: int):
    """codes uint8 [..., L] (0-3 a base, anything else bad) -> (canon
    uint64 [..., P], valid bool [..., P]), P = L - k + 1: canon = min(fwd,
    rc) with the first base most significant, 0 where a window holds a bad
    base. Windows of 2^j bases are built by doubling, then joined to k."""
    codes = np.asarray(codes)
    L = codes.shape[-1]
    P = L - k + 1
    lead = codes.shape[:-1]
    if P <= 0:
        return (np.zeros(lead + (0,), np.uint64),
                np.zeros(lead + (0,), bool))
    bad = codes > 3
    c = np.where(bad, 0, codes).astype(np.uint64)
    fwd_of = {1: c}
    rc_of = {1: np.uint64(3) - c}
    m = 1
    while 2 * m <= k:
        f, r = fwd_of[m], rc_of[m]
        fwd_of[2 * m] = (f[..., :-m] << np.uint64(2 * m)) | f[..., m:]
        rc_of[2 * m] = r[..., :-m] | (r[..., m:] << np.uint64(2 * m))
        m *= 2
    fwd = rc = None
    off = 0
    for m in sorted(fwd_of, reverse=True):
        if k - off < m:
            continue
        f = fwd_of[m][..., off:off + P]
        r = rc_of[m][..., off:off + P]
        fwd = f if fwd is None else (fwd << np.uint64(2 * m)) | f
        rc = r if rc is None else rc | (r << np.uint64(2 * off))
        off += m
    nbad = np.concatenate([np.zeros(lead + (1,), np.int64),
                           np.cumsum(bad, axis=-1, dtype=np.int64)], -1)
    valid = (nbad[..., k:] - nbad[..., :P]) == 0
    return np.where(valid, np.minimum(fwd, rc), np.uint64(0)), valid


def _mix32(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & M32
    v ^= v >> np.uint64(16)
    v = (v * np.uint64(0x85EBCA6B)) & M32
    v ^= v >> np.uint64(13)
    v = (v * np.uint64(0xC2B2AE35)) & M32
    v ^= v >> np.uint64(16)
    return v


def hash32(canon: np.ndarray) -> np.ndarray:
    """SEMANTICS.md §4: mix32(mix32(lo ^ 0x9E3779B9) ^ hi), as uint64."""
    canon = np.asarray(canon, dtype=np.uint64)
    hi, lo = canon >> np.uint64(32), canon & M32
    return _mix32(_mix32(lo ^ np.uint64(0x9E3779B9)) ^ hi)


def query_probes(codes: np.ndarray, k: int, w: int):
    """The classify side's probes of reads codes [n, L] (§3): every k-mer
    position for w = 1; for w > 1 the hash-argmin position (leftmost) of
    each disjoint full window of w positions, a window valid when all its
    positions are. Returns (canon uint64 [n, NW], valid bool [n, NW])."""
    canon, valid = canonical_kmers(codes, k)
    if w <= 1:
        return canon, valid
    n, P = canon.shape
    NW = P // w
    h = hash32(canon[:, :NW * w]).reshape(n, NW, w)
    sel = np.argmin(h, axis=2)
    pick = canon[:, :NW * w].reshape(n, NW, w)
    out = np.take_along_axis(pick, sel[..., None], axis=2)[..., 0]
    wvalid = valid[:, :NW * w].reshape(n, NW, w).all(axis=2)
    return np.where(wvalid, out, np.uint64(0)), wvalid


def genome_kmers(codes: np.ndarray, k: int, w: int) -> np.ndarray:
    """The build side's k-mers of one genome (§3), in sequence order and
    with repeats: every valid k-mer for w = 1; for w > 1 the hash-argmin
    (leftmost) of each window of w consecutive valid positions."""
    canon, valid = canonical_kmers(np.asarray(codes), k)
    if w <= 1:
        return canon[valid]
    P = canon.shape[0]
    if P < w:
        return np.zeros(0, np.uint64)
    h = hash32(canon)
    nbad = np.concatenate([[0], np.cumsum(~valid, dtype=np.int64)])
    whole = (nbad[w:] - nbad[:P - w + 1]) == 0
    arg = np.argmin(np.lib.stride_tricks.sliding_window_view(h, w), axis=1)
    return canon[(np.arange(P - w + 1) + arg)[whole]]
