"""Canonical k-mer extraction (SEMANTICS.md §1-2), plain PyTorch.

Counterpart of ``pangea_tpu/kernels/encode.py`` ``extract_kmers_jnp``. A
TPU has no 64-bit integers, so the reference builds k-mers by log-doubling
merges of 32-bit halves; here the 2k-bit forward and reverse-complement
values are built in int64 (k <= 31 keeps them below 2^62). On the card the
extraction runs fused with minimizer selection in kernel K1
(:func:`pangea_tpu_torch.kernels.minimize.extract_probes`).
"""
from __future__ import annotations

import torch

from .lookup import M32, narrow


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
