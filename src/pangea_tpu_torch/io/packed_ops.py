"""Trim, length filter, demultiplexing and barcode stripping on the packed
wire rows of the fast path, on the host, numpy only.

The port's copy of ``pangea_tpu/io/packed_ops.py``. The native reader
(``io/native.py`` ``next_batch_packed``) gives each read one uint32 row of
W16 = ceil(L/16) code words (base j in bits [2*(j%16), +2) of word j/16)
then W32 = ceil(L/32) bad-mask words (bit j%32 of word j/32 set when base
j is ambiguous or past the read). These functions work on whole batches
of such rows with word arithmetic, with no per-read Python objects, and
give the same results as the per-read rules of ``io/trim.py`` and
``io/demux.py`` (``tests/test_torch_cohort.py`` holds both to the
reference's).
"""
from __future__ import annotations

import numpy as np

_ALL_BAD = np.uint32(0xFFFFFFFF)


def wire_widths(L: int) -> tuple[int, int]:
    """(W16, W32) word counts of the packed row for max_len L."""
    return (L + 15) // 16, (L + 31) // 32


def qtrim_cut(quals: np.ndarray, lens: np.ndarray, min_qual: float,
              window: int) -> np.ndarray:
    """The 3' quality rule of ``io.trim._trim_one`` on a batch: the new
    length is the first window-anchored position whose mean phred is below
    min_qual (reads shorter than ``window`` pass through). quals: uint8
    [B, L] (0-padded); lens: stored lengths (≤ L).

    Window sums accumulate in uint16 (int32 past a window of 256) and are
    compared with s_crit, the least integer sum whose float mean
    (fl(s / window), the per-read rule's arithmetic) reaches min_qual,
    found by scanning the at most 255 * window + 1 possible sums: mean <
    min_qual exactly when sum < s_crit, so the cut equals the per-read
    rule's for every window and quality."""
    B, L = quals.shape
    lens = np.minimum(np.asarray(lens, np.int64), L)
    if min_qual <= 0 or L < window:
        return lens.astype(np.int32)
    sums = np.arange(255 * window + 2, dtype=np.int64)
    ge = np.flatnonzero(sums / window >= min_qual)
    acc_t = np.uint16 if window <= 256 else np.int32
    s_crit = acc_t(ge[0]) if ge.size else acc_t(255 * window + 2)
    nwin = L - window + 1
    wsum = quals[:, :nwin].astype(acc_t)
    for j in range(1, window):
        wsum += quals[:, j:j + nwin]
    bad = (wsum < s_crit)
    bad &= np.arange(nwin)[None, :] <= (lens[:, None] - window)
    has = bad.any(axis=1)
    cut = np.where(has, bad.argmax(axis=1), lens)
    return np.where(lens >= window, cut, lens).astype(np.int32)


def unpack_head(rows: np.ndarray, L: int, m: int):
    """(codes uint8 [B, m], bad bool [B, m]) for the first m ≤ 32 bases."""
    if m > 32:
        raise ValueError("unpack_head supports m <= 32")
    w16, _ = wire_widths(L)
    nw = (m + 15) // 16
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    codes = ((rows[:, :nw, None] >> shifts) & np.uint32(3)) \
        .reshape(rows.shape[0], nw * 16)[:, :m].astype(np.uint8)
    nb = (m + 31) // 32
    bshifts = np.arange(32, dtype=np.uint32)[None, None, :]
    bad = ((rows[:, w16:w16 + nb, None] >> bshifts) & np.uint32(1)) \
        .reshape(rows.shape[0], nb * 32)[:, :m].astype(bool)
    return codes, bad


def demux_assign(rows: np.ndarray, L: int, lens: np.ndarray,
                 bc_codes: list[np.ndarray], max_mismatch: int):
    """The assignment rule of ``io.demux.demux_batch`` on a batch: (bin
    int32 [B], the index into bc_codes or -1 for undetermined; strip int32
    [B]). The first barcode in config order whose Hamming distance over
    its prefix is ≤ max_mismatch wins; ambiguous bases never match; reads
    shorter (after trimming, lens) than a barcode skip it."""
    B = rows.shape[0]
    mb = max(len(b) for b in bc_codes)
    heads, badh = unpack_head(rows, L, mb)
    lens = np.asarray(lens, np.int64)
    bin_idx = np.full(B, -1, np.int32)
    strip = np.zeros(B, np.int32)
    for bi, bc in enumerate(bc_codes):
        m = len(bc)
        mism = ((heads[:, :m] != bc[None, :].astype(np.uint8))
                | badh[:, :m]).sum(axis=1)
        ok = (bin_idx < 0) & (lens >= m) & (mism <= max_mismatch)
        bin_idx[ok] = bi
        strip[ok] = m
    return bin_idx, strip


def _shift_unit_stream(words: np.ndarray, units_per_word: int, s: int,
                       fill: np.uint32) -> np.ndarray:
    """Left-shift a packed unit stream (units_per_word fixed-width units a
    uint32 word, low bits first) by s units; the vacated tail units read
    from ``fill`` words."""
    N, W = words.shape
    sw, su = divmod(s, units_per_word)
    sb = (32 // units_per_word) * su
    pad = np.full((N, min(sw, W) + 1), fill, np.uint32)
    ext = np.concatenate([words[:, sw:], pad], axis=1)
    if sb == 0:
        return np.ascontiguousarray(ext[:, :W])
    return (((ext[:, :W] >> np.uint32(sb))
             | (ext[:, 1:W + 1] << np.uint32(32 - sb)))
            .astype(np.uint32))


def strip_rows(rows: np.ndarray, L: int, strip: np.ndarray) -> np.ndarray:
    """Remove the first strip[i] bases of each packed row (the barcode):
    code words shift by 2-bit units, bad words by 1-bit units (vacated tail
    positions become bad), a group of rows a distinct strip value. Returns
    new rows; the caller adjusts the lengths."""
    w16, w32 = wire_widths(L)
    out = rows.copy()
    for s in np.unique(strip):
        s = int(s)
        if s == 0:
            continue
        sel = np.flatnonzero(strip == s)
        out[np.ix_(sel, np.arange(w16))] = _shift_unit_stream(
            rows[sel, :w16], 16, s, np.uint32(0))
        out[np.ix_(sel, w16 + np.arange(w32))] = _shift_unit_stream(
            rows[sel, w16:w16 + w32], 32, s, _ALL_BAD)
    return out


def mask_tail(rows: np.ndarray, L: int, lens: np.ndarray) -> np.ndarray:
    """Set the bad bit of every position ≥ lens[i] (a trim or truncation
    cut applied as a mask; idempotent on already-bad padding). Mutates and
    returns rows."""
    w16, w32 = wire_widths(L)
    lens = np.asarray(lens, np.int64)
    for t in range(w32):
        k = np.clip(lens - 32 * t, 0, 32)
        ones_above = np.where(
            k >= 32, np.uint64(0),
            np.uint64(0xFFFFFFFF) << k.astype(np.uint64))
        rows[:, w16 + t] |= ones_above.astype(np.uint32)
    return rows
