"""Canonical k-mer extraction (SEMANTICS.md §1-2), plain PyTorch.

Counterpart of ``pangea_tpu/kernels/encode.py`` ``extract_kmers_jnp``,
``unpack_wire`` and ``extract_kmers_packed_jnp`` (the native reader's
packed wire rows, B7). A TPU has no 64-bit integers, so the reference
builds k-mers by log-doubling merges of 32-bit halves; here the 2k-bit
forward and reverse-complement values are built in int64 (k <= 31 keeps
them below 2^62). On the card the
extraction runs fused with minimizer selection in kernel K1
(:func:`pangea_tpu_torch.kernels.minimize.extract_probes`).
"""
from __future__ import annotations

import torch

from .lookup import M32, narrow, widen


def wire_width(L: int) -> int:
    """int32 words of a packed wire row of L bases: ceil(L/16) words of
    2-bit codes, then ceil(L/32) words of bad flags."""
    return (L + 15) // 16 + (L + 31) // 32


def unpack_wire(rows: torch.Tensor, L: int):
    """Decode packed wire rows (the native reader's
    ``pangea_fastx_next_batch_packed``): rows int32 [B, >= wire_width(L)]
    hold base j in bits [2(j%16), +2) of word j//16 and its bad flag in
    bit j%32 of word ceil(L/16) + j//32. Returns (c2, bad) int32 [B, L]."""
    w16 = (L + 15) // 16
    pos = torch.arange(L, device=rows.device)
    words = widen(rows[:, pos >> 4])
    c2 = (words >> (2 * (pos & 15))) & 3
    bad = (widen(rows[:, w16 + (pos >> 5)]) >> (pos & 31)) & 1
    return c2.to(torch.int32), bad.to(torch.int32)


def wire_codes(rows: torch.Tensor, L: int) -> torch.Tensor:
    """Packed wire rows -> int8 [B, L] codes: c2, or 4 where the bad flag
    is set (every k-mer over a bad base is invalid either way)."""
    c2, bad = unpack_wire(rows, L)
    return torch.where(bad != 0, 4, c2).to(torch.int8)


def extract_kmers_packed(rows: torch.Tensor, L: int, k: int):
    """:func:`extract_kmers` of packed wire rows of L bases."""
    return extract_kmers(wire_codes(rows, L), k)


def extract_kmers(codes: torch.Tensor, k: int):
    """codes int8 [B, L] (0..3 bases; anything else, negatives included,
    is N or padding) -> (hi, lo, valid): int32 bit patterns and bool
    [B, P], P = L - k + 1. Invalid positions carry canonical 0."""
    B, L = codes.shape
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"read length {L} shorter than k={k}")
    c = codes.to(torch.int64)
    bad = (c < 0) | (c > 3)
    c2 = c & 3
    fwd = torch.zeros((B, P), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fwd)
    anybad = torch.zeros((B, P), dtype=torch.bool, device=codes.device)
    for j in range(k):
        cj = c2[:, j:j + P]
        fwd = (fwd << 2) | cj
        rc = rc | ((3 - cj) << (2 * j))
        anybad = anybad | bad[:, j:j + P]
    valid = ~anybad
    canon = torch.where(valid, torch.minimum(fwd, rc), 0)
    return narrow(canon >> 32), narrow(canon & M32), valid
