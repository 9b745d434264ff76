"""hash32 and the q8 table probe (SEMANTICS.md §4-5).

Counterpart of ``pangea_tpu/kernels/lookup.py``: ``mix32``/``hash32``
(``mix32_jnp``/``hash32_jnp``) and ``lookup_q8`` (``lookup_q8_jnp``).

Lane rule: 32-bit unsigned lanes live in ``torch.int32`` tensors holding
the uint32 bit pattern. The plain versions widen them to int64
(:func:`widen`), keep every product below 2^63 by multiplying in 16-bit
halves (:func:`_mul32`) and narrow back at the end (:func:`narrow`).
"""
from __future__ import annotations

import torch

from . import _build

M32 = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_Q8_A = 0x9E3779B1
_PLAIN_CHUNK = 1 << 16               # probes a plain-lookup step


def widen(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the uint32 value."""
    return x.to(torch.int64) & M32


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 bit pattern of its low 32 bits."""
    x = x & M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _mul32(v: torch.Tensor, c: int) -> torch.Tensor:
    """(v * c) mod 2^32 for v in [0, 2^32) int64 and a constant c < 2^32,
    with every intermediate below 2^49."""
    return (v * (c & 0xFFFF) + (((v * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix32(v: torch.Tensor) -> torch.Tensor:
    v = v ^ (v >> 16)
    v = _mul32(v, 0x85EBCA6B)
    v = v ^ (v >> 13)
    v = _mul32(v, 0xC2B2AE35)
    return v ^ (v >> 16)


def _hash32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """hash32 on widened lanes; returns the uint32 value as int64."""
    return _mix32(_mix32(lo ^ _GOLD) ^ hi)


def mix32(v: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 fmix32 finalizer on int32 bit patterns."""
    return narrow(_mix32(widen(v)))


def hash32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """fmix32(fmix32(lo ^ 0x9E3779B9) ^ hi) on int32 bit patterns."""
    return narrow(_hash32(widen(hi), widen(lo)))


def _q8_split(hi, lo, k: int, log2nb: int):
    """(bucket, rem) int64 of h = (K * A) mod 2^(2k) for widened lanes."""
    m = 2 * k
    r = m - log2nb
    p0 = lo * (_Q8_A & 0xFFFF)                  # < 2^48
    p1 = lo * (_Q8_A >> 16)                     # < 2^48
    h_lo = (p0 + ((p1 & 0xFFFF) << 16)) & M32
    if m > 32:
        umulh = ((p0 >> 16) + p1) >> 16         # high half of lo * A
        h_hi = (umulh + _mul32(hi, _Q8_A)) & ((1 << (m - 32)) - 1)
    else:
        h_lo = h_lo & ((1 << m) - 1)
        h_hi = torch.zeros_like(h_lo)
    h = (h_hi << 32) | h_lo
    return h >> r, h & ((1 << r) - 1)


def _q8_geometry(fused: torch.Tensor, k: int):
    nb = fused.shape[0]
    log2nb = nb.bit_length() - 1
    r = 2 * k - log2nb
    if nb != 1 << log2nb or not 0 <= r <= 31:
        raise ValueError(f"q8 table with NB={nb} and k={k}: the remainder "
                         f"width {r} is outside [0, 31]")
    return log2nb, fused.shape[1] // 2


def lookup_q8_plain(hi, lo, valid, fused, stash, k: int):
    """Plain PyTorch q8 probe (any device). hi/lo int32 bit patterns and
    valid bool, any shape; fused int32 [NB, 2W] (rem lanes, then payload
    lanes); stash int32 [5, S]. Returns (hit, t_in, t_out) int32 like hi."""
    log2nb, W = _q8_geometry(fused, k)
    shape = hi.shape
    hi, lo, valid = hi.reshape(-1), lo.reshape(-1), valid.reshape(-1)
    outs = []
    for s in range(0, max(hi.shape[0], 1), _PLAIN_CHUNK):
        h_c, l_c, v_c = (x[s:s + _PLAIN_CHUNK] for x in (hi, lo, valid))
        hw, lw = widen(h_c), widen(l_c)
        bucket, rem = _q8_split(hw, lw, k, log2nb)
        rows = fused[bucket]                            # [n, 2W]
        match = v_c[:, None] & (widen(rows[:, :W]) == rem[:, None])
        pk = torch.where(match, widen(rows[:, W:]), 0).sum(1) & M32
        t_in = pk >> 16
        t_out = pk & 0xFFFF
        hit = (pk != 0).to(torch.int64)
        if stash.shape[1]:
            shit = (v_c[:, None] & (h_c[:, None] == stash[0][None, :])
                    & (l_c[:, None] == stash[1][None, :]))
            t_in = t_in + torch.where(shit, widen(stash[3])[None, :],
                                      0).sum(1)
            t_out = t_out + torch.where(shit, widen(stash[4])[None, :],
                                        0).sum(1)
            hit = hit + shit.sum(1)
        outs.append((narrow(hit), narrow(t_in), narrow(t_out)))
    return tuple(torch.cat(o).reshape(shape) for o in zip(*outs))


def lookup_q8(hi, lo, valid, fused, stash, k: int):
    """q8 probe: the plain version for CPU tensors, kernel K2
    (``csrc/lookup_q8.cu``) for CUDA tensors. Same contract as
    :func:`lookup_q8_plain`."""
    dev = _build.dispatch_device(hi, lo, valid, fused, stash)
    if dev is None:
        return lookup_q8_plain(hi, lo, valid, fused, stash, k)
    _build.check(hi, torch.int32, name="hi")
    _build.check(lo, torch.int32, shape=hi.shape, name="lo")
    _build.check(valid, torch.bool, shape=hi.shape, name="valid")
    _build.check(fused, torch.int32, ndim=2, name="fused")
    _build.check(stash, torch.int32, ndim=2, name="stash")
    if not 1 <= k <= 31:
        raise ValueError(f"k={k} outside 1..31")
    _, W = _q8_geometry(fused, k)
    if fused.shape[1] != 2 * W or stash.shape[0] != 5:
        raise ValueError(f"fused {tuple(fused.shape)} / stash "
                         f"{tuple(stash.shape)} are not q8 tables")
    hit = torch.empty(hi.shape, dtype=torch.int32, device=dev)
    t_in = torch.empty_like(hit)
    t_out = torch.empty_like(hit)
    _build.launch("pangea_lookup_q8", dev, hi.data_ptr(), lo.data_ptr(),
                  valid.data_ptr(), hi.numel(), fused.data_ptr(),
                  fused.shape[0], W, stash.data_ptr(), stash.shape[1], k,
                  hit.data_ptr(), t_in.data_ptr(), t_out.data_ptr())
    lookup_q8.launches += 1
    return hit, t_in, t_out


lookup_q8.launches = 0
