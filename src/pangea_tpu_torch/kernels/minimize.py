"""Disjoint-window minimizer selection (SEMANTICS.md §3) and the fused
extract + minimize step.

Counterpart of ``pangea_tpu/kernels/minimize.py`` ``select_minimizers_jnp``
and of the extract/minimize part of ``classify/engine.py``
``_extract_probes``. :func:`extract_probes` runs kernel K1
(``csrc/extract_probes.cu``) on CUDA tensors and the plain composition of
:func:`extract_kmers` and :func:`select_minimizers` on CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build
from .encode import extract_kmers
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


def extract_probes_plain(codes, k: int, w: int, out, col0: int) -> None:
    """Plain PyTorch K1 (any device): write the probes of codes int8
    [B, L] into columns [col0, col0 + NW) of out = (hi, lo, valid)
    [B, R]."""
    NW = probe_width(codes.shape[1], k, w)
    hi, lo, valid = extract_kmers(codes, k)
    if w > 1:
        hi, lo, valid = select_minimizers(hi, lo, valid, w)
    for dst, src in zip(out, (hi, lo, valid)):
        dst[:, col0:col0 + NW] = src


def extract_probes(codes, k: int, w: int, out, col0: int) -> None:
    """Probes of codes int8 [B, L] into columns [col0, col0 + NW) of
    out = (hi int32, lo int32, valid bool) [B, R]: the plain version for
    CPU tensors, kernel K1 for CUDA tensors."""
    hi, lo, valid = out
    dev = _build.dispatch_device(codes, hi, lo, valid)
    if dev is None:
        return extract_probes_plain(codes, k, w, out, col0)
    B, L = codes.shape
    NW = probe_width(L, k, w)
    if not 1 <= k <= 31 or w < 1:
        raise ValueError(f"k={k} outside 1..31 or w={w} < 1")
    _build.check(codes, torch.int8, ndim=2, name="codes")
    _build.check(hi, torch.int32, ndim=2, name="hi")
    R = hi.shape[1]
    _build.check(lo, torch.int32, shape=(B, R), name="lo")
    _build.check(valid, torch.bool, shape=(B, R), name="valid")
    if hi.shape[0] != B or not 0 <= col0 <= R - NW:
        raise ValueError(f"columns [{col0}, {col0 + NW}) do not fit "
                         f"outputs of shape {tuple(hi.shape)} for {B} reads")
    _build.launch("pangea_extract_probes", dev, codes.data_ptr(), B, L, k,
                  w, hi.data_ptr(), lo.data_ptr(), valid.data_ptr(), R, col0)
    extract_probes.launches += 1


extract_probes.launches = 0
