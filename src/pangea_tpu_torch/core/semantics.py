"""The frozen k-mer semantics on the host, numpy only (docs/SEMANTICS.md
§1-§4).

The port's copy of ``pangea_tpu/core/semantics_np.py``, with the parts the
index builder, the FASTQ reader, demultiplexing and the golden model use:
base codes (``encode_bases``, ``revcomp_codes``), canonical k-mers, hash32,
the build-side minimizer mask and the classify-side disjoint minimizers.
``tests/test_torch_host.py`` and ``tests/test_torch_golden.py`` hold it
equal to the reference.
"""
from __future__ import annotations

import numpy as np

AMBIG = np.uint8(4)  # SEMANTICS.md §1

# 256-entry base→code LUT (case-insensitive; U→T; everything else AMBIG).
_BASE_LUT = np.full(256, AMBIG, dtype=np.uint8)
for _b, _c in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    _BASE_LUT[ord(_b)] = _c
    _BASE_LUT[ord(_b.lower())] = _c


def encode_bases(seq) -> np.ndarray:
    """ASCII sequence (str/bytes) → uint8 codes per SEMANTICS.md §1."""
    if isinstance(seq, str):
        seq = seq.encode("ascii", errors="replace")
    raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    return _BASE_LUT[raw]


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement a code array (AMBIG maps to AMBIG)."""
    out = codes[::-1].copy()
    acgt = out <= 3
    out[acgt] = 3 - out[acgt]
    return out


def canonical_kmers(codes: np.ndarray, k: int):
    """All k-mer positions of one sequence.

    Returns ``(canon: uint64[P], valid: bool[P])`` with P = max(len-k+1, 0).
    canon[i] = min(fwd, rc) per SEMANTICS.md §2; invalid positions carry
    canon value 0.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    L = codes.shape[0]
    P = L - k + 1
    if P <= 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=bool)
    good = codes <= 3
    # valid[i] = all(good[i:i+k]) via cumulative sum of violations.
    bad = (~good).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:P]) == 0
    c64 = np.clip(codes, 0, 3).astype(np.uint64)   # invalid k-mers zeroed below
    cc64 = np.uint64(3) - c64                      # complement
    # Big-endian forward value and rc value of every position at once, one
    # base offset a pass: base j of a k-mer is bits 2(k-1-j) of fwd and
    # 2j of rc.
    fwd = np.zeros(P, dtype=np.uint64)
    rc = np.zeros(P, dtype=np.uint64)
    for j in range(k):
        fwd <<= np.uint64(2)
        fwd |= c64[j:j + P]
        rc |= cc64[j:j + P] << np.uint64(2 * j)
    canon = np.where(fwd <= rc, fwd, rc)
    canon = np.where(valid, canon, np.uint64(0))
    return canon, valid


def mix32_np(v: np.ndarray) -> np.ndarray:
    """MurmurHash3 fmix32 finalizer, elementwise on uint32 (SEMANTICS.md §4)."""
    v = v.astype(np.uint32)
    v ^= v >> np.uint32(16)
    v = (v * np.uint32(0x85EBCA6B)).astype(np.uint32)
    v ^= v >> np.uint32(13)
    v = (v * np.uint32(0xC2B2AE35)).astype(np.uint32)
    v ^= v >> np.uint32(16)
    return v


def hash32_np(canon: np.ndarray) -> np.ndarray:
    """uint64 canonical k-mers → uint32 table hash (SEMANTICS.md §4)."""
    canon = np.asarray(canon, dtype=np.uint64)
    hi = (canon >> np.uint64(32)).astype(np.uint32)
    lo = (canon & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h = mix32_np(lo ^ np.uint32(0x9E3779B9))
    h = mix32_np(h ^ hi)
    return h


def disjoint_query_minimizers(canon: np.ndarray, valid: np.ndarray, w: int):
    """Classify-side minimizer selection for w > 1 (SEMANTICS.md §3 v4).

    The read's P k-mer positions are cut into NW = floor(P/w) consecutive
    disjoint FULL windows (a tail of fewer than w positions is ignored); a
    window is valid iff all its w positions are valid; each valid window
    probes its hash32-argmin position (ties → leftmost). Returns
    (pos: int64[NW] selected position per window, wvalid: bool[NW]).
    """
    P = canon.shape[0]
    if w <= 1:
        raise ValueError("disjoint_query_minimizers requires w>1")
    NW = P // w
    h = hash32_np(canon)[:NW * w]
    hw = h.reshape(NW, w)
    vw = np.asarray(valid[:NW * w], dtype=bool).reshape(NW, w)
    wvalid = vw.all(axis=1)
    sel = np.argmin(hw, axis=1)  # first occurrence = leftmost tie
    pos = np.arange(NW, dtype=np.int64) * w + sel
    return pos, wvalid


def minimizer_mask(canon: np.ndarray, valid: np.ndarray, w: int) -> np.ndarray:
    """SEMANTICS.md §3: boolean mask of k-mer positions selected as window
    minimizers (w consecutive *valid* positions; ties → leftmost). w == 1
    selects every valid position. Invalid positions are never selected and
    break windows."""
    P = canon.shape[0]
    sel = np.zeros(P, dtype=bool)
    if w <= 1:
        return valid.copy()
    if P < w:
        return sel
    h = hash32_np(canon)
    # A window starts at s iff positions s..s+w-1 are all valid; its
    # selection = s + argmin(h[s:s+w]) (first occurrence = leftmost tie).
    bad = (~np.asarray(valid, dtype=bool)).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    win_ok = (cs[w:] - cs[:P - w + 1]) == 0          # [P-w+1]
    hv = np.lib.stride_tricks.sliding_window_view(h, w)  # [P-w+1, w]
    arg = np.argmin(hv, axis=1)                      # leftmost min per window
    pos = np.arange(P - w + 1) + arg
    sel[pos[win_ok]] = True
    return sel
