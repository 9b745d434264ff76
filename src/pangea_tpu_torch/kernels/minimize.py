"""Disjoint-window minimizer selection (SEMANTICS.md §3) and the fused
extract + minimize step.

Counterpart of ``pangea_tpu/kernels/minimize.py`` ``select_minimizers_jnp``
and of the extract/minimize part of ``classify/engine.py``
``_extract_probes``. :func:`extract_probes` runs kernel K1
(``csrc/extract_probes.cu``) on CUDA tensors and the plain composition of
:func:`extract_kmers` and :func:`select_minimizers` on CPU tensors. With
``packed_len=L`` the input is packed wire rows (B7) and the launch is K1's
packed form, counted on :func:`extract_probes_packed`. :func:`k1_plan`
sizes K1's launch to the card.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .encode import extract_kmers, wire_codes, wire_width
from .lookup import _hash32, widen


def select_minimizers(hi, lo, valid, w: int):
    """hi/lo int32 bit patterns and valid bool [B, P] -> (hi_m, lo_m,
    wvalid) [B, NW], NW = P // w: per disjoint full window, the k-mer of
    the leftmost hash32 minimum; a window is valid iff all its positions
    are."""
    B, P = hi.shape
    NW = P // w
    if NW == 0:
        raise ValueError(f"read positions {P} shorter than window {w}")
    n = NW * w
    h = _hash32(widen(hi[:, :n]), widen(lo[:, :n])).reshape(B, NW, w)
    arg = h.argmin(dim=2, keepdim=True)          # first minimum

    def pick(x):
        return x[:, :n].reshape(B, NW, w).gather(2, arg)[..., 0]

    wvalid = valid[:, :n].reshape(B, NW, w).all(dim=2)
    return pick(hi), pick(lo), wvalid


def probe_width(L: int, k: int, w: int) -> int:
    """Probes a read of L codes yields: NW = (L - k + 1) // w."""
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"read length {L} shorter than k={k}")
    if P // w == 0:
        raise ValueError(f"read positions {P} shorter than window {w}")
    return P // w


def extract_probes_plain(codes, k: int, w: int, out, col0: int,
                         packed_len: int = 0) -> None:
    """Plain PyTorch K1 (any device): write the probes of codes int8
    [B, L] (or, packed_len=L, of packed wire rows int32 [B, >=
    wire_width(L)]) into columns [col0, col0 + NW) of out = (hi, lo,
    valid) [B, R]."""
    if packed_len:
        codes = wire_codes(codes, packed_len)
    NW = probe_width(codes.shape[1], k, w)
    hi, lo, valid = extract_kmers(codes, k)
    if w > 1:
        hi, lo, valid = select_minimizers(hi, lo, valid, w)
    for dst, src in zip(out, (hi, lo, valid)):
        dst[:, col0:col0 + NW] = src


# K1's launch (kernels.extract_sweep times the choices on an H100: the
# block size moves nothing; 64 warps an SM before a read is cut beat 32 on
# a 75 x 16,384-base bucket at w = 8 by about 13 %):
K1_WARPS = 8             # warps a block (csrc/extract_probes.cu kMaxWarps)
K1_SM_WARPS = 64         # warps an SM the grid should hold before reads
#                          are cut into tiles of fewer windows


class K1Plan(NamedTuple):
    """K1's launch: ``grid`` blocks of ``warps`` warps, a warp a (read,
    tile); a read is ``tiles`` tiles of ``tile_windows`` windows (a
    multiple of 32, the last tile cut at NW)."""
    grid: int
    warps: int
    tiles: int
    tile_windows: int


@functools.lru_cache(maxsize=256)
def k1_plan(B: int, L: int, k: int, w: int, sms: int,
            warps: int = K1_WARPS, sm_warps: int = K1_SM_WARPS) -> K1Plan:
    """The launch of K1 for B reads of L bases at (k, w) on a card of
    ``sms`` SMs, in blocks of ``warps`` warps. A warp walks its tile in
    rounds of 32 windows; a read is one tile unless the B reads give the
    card fewer than ``sm_warps`` warps an SM, and then it is cut into as
    many tiles of whole rounds as make up that many (a long-read bucket:
    75 reads of 16,384 bases at w = 1 take 103 tiles of 160 windows).
    Raises where the read has no window or an argument is out of
    range."""
    if not 1 <= k <= 31 or w < 1 or B < 0 or sms < 1 or not (
            1 <= warps <= K1_WARPS) or sm_warps < 1:
        raise ValueError(f"k={k} outside 1..31, w={w} < 1, B={B}, "
                         f"sms={sms}, warps={warps} or sm_warps={sm_warps}")
    NW = probe_width(L, k, w)
    rounds = -(-NW // 32)
    tiles = min(rounds, -(-sms * sm_warps // max(B, 1)))
    tile_windows = 32 * -(-rounds // tiles)
    tiles = -(-NW // tile_windows)
    items = B * tiles
    if items >= 1 << 31 or 32 * (L + 128) >= 1 << 31:
        raise ValueError(f"{B} reads of {L} bases: past K1's int32 walk")
    warps = max(1, min(warps, items))
    return K1Plan(-(-items // warps), warps, tiles, tile_windows)


# K1's least 32-bit operations at a position its windows cover: the k-mer
# and its validity test (five 64-bit operations, the shift out of the
# stream, its mask, the complement, the pair reversal and the min, and a
# 64-bit mask test, two 32-bit operations each), and where w > 1 its
# hash32 (two fmix32 of eight operations and two xors).
K1_KMER_OPS, K1_HASH_OPS = 12, 18


def k1_cost(reads: int, L: int, k: int, w: int,
            in_bytes: int) -> tuple[int, int]:
    """(bytes, operations) K1 must move and do for ``reads`` reads of L
    bases at (k, w), each read's input ``in_bytes`` bytes (L codes, or 4
    bytes a wire word): the input read once and 9 bytes a probe written
    once; K1_KMER_OPS (+ K1_HASH_OPS where w > 1) at each of the NW x w
    positions its windows cover and w - 1 compares a window."""
    nw = probe_width(L, k, w)
    per_pos = K1_KMER_OPS + (K1_HASH_OPS if w > 1 else 0)
    return (reads * (in_bytes + 9 * nw),
            reads * nw * (w * per_pos + w - 1))


def _launch_k1(dev, codes, L: int, pitch: int, packed: bool, k: int,
               w: int, out, col0: int, plan: K1Plan | None = None) -> None:
    B = codes.shape[0]
    NW = probe_width(L, k, w)
    if plan is None:
        plan = k1_plan(B, L, k, w, _build.sm_count(dev.index))
    hi, lo, valid = out
    _build.check(hi, torch.int32, ndim=2, name="hi")
    R = hi.shape[1]
    _build.check(lo, torch.int32, shape=(B, R), name="lo")
    _build.check(valid, torch.bool, shape=(B, R), name="valid")
    if hi.shape[0] != B or not 0 <= col0 <= R - NW:
        raise ValueError(f"columns [{col0}, {col0 + NW}) do not fit "
                         f"outputs of shape {tuple(hi.shape)} for {B} reads")
    _build.launch("pangea_extract_probes", dev, codes.data_ptr(), B, L, k,
                  w, hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), R, col0,
                  int(packed), pitch, *plan)


def extract_probes(codes, k: int, w: int, out, col0: int,
                   packed_len: int = 0) -> None:
    """Probes of codes int8 [B, L] into columns [col0, col0 + NW) of
    out = (hi int32, lo int32, valid bool) [B, R]: the plain version for
    CPU tensors, kernel K1 for CUDA tensors. packed_len=L takes packed
    wire rows instead (:func:`extract_probes_packed`)."""
    if packed_len:
        return extract_probes_packed(codes, packed_len, k, w, out, col0)
    dev = _build.dispatch_device(codes, *out)
    if dev is None:
        return extract_probes_plain(codes, k, w, out, col0)
    _build.check(codes, torch.int8, ndim=2, name="codes")
    _launch_k1(dev, codes, codes.shape[1], codes.shape[1], False, k, w, out,
               col0)
    extract_probes.launches += 1


def extract_probes_packed(rows, L: int, k: int, w: int, out,
                          col0: int) -> None:
    """Probes of packed wire rows of L bases (int32 [B, >= wire_width(L)],
    rows may be a column slice of a wider batch: only the last dimension
    must be dense) into columns [col0, col0 + NW) of out: the plain version
    for CPU tensors, K1's packed form for CUDA tensors."""
    dev = _build.dispatch_device(rows, *out)
    if dev is None:
        return extract_probes_plain(rows, k, w, out, col0, packed_len=L)
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise TypeError(f"rows: {rows.dtype} {rows.dim()}-d, the packed "
                        "form takes int32 [B, words]")
    if rows.shape[1] < wire_width(L) or rows.stride(1) != 1:
        raise ValueError(f"rows {tuple(rows.shape)} (strides "
                         f"{rows.stride()}) do not hold dense wire rows of "
                         f"{L} bases ({wire_width(L)} words)")
    _launch_k1(dev, rows, L, rows.stride(0), True, k, w, out, col0)
    extract_probes_packed.launches += 1


extract_probes.launches = 0
extract_probes_packed.launches = 0
