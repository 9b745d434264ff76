"""Per-read consensus score and LCA for the q8 path (SEMANTICS.md §7).

Counterpart of ``pangea_tpu/kernels/score.py`` ``score_reads_tin_jnp``
with the quadratic pscore (``_pscore_quadratic``) and the direct LCA scan
(``_lca_by_tin_direct``). :func:`score_reads_tin` runs kernel K3
(``csrc/score_tin.cu``) on CUDA tensors and :func:`score_reads_tin_plain`
on CPU tensors.
"""
from __future__ import annotations

import torch

from . import _build

_I32_MAX = 2**31 - 1
# Kernel K3 limits: its four [R] shared-memory arrays, and the direct LCA
# scan (bigger taxonomies take binary lifting, ROADMAP B12).
MAX_PROBES = 2048
MAX_TAXA = 4096


def score_reads_tin_plain(hit, t_in, t_out, valid, tin, tout, depth,
                          confidence_threshold: float):
    """Plain PyTorch K3 (any device). hit/t_in/t_out int32 and valid bool
    [B, R]; tin/tout/depth int32 [T+1]. Returns (taxon, best, nvalid)
    int32 [B]."""
    hitb = hit != 0
    anc = ((t_in[:, :, None] <= t_in[:, None, :])
           & (t_in[:, None, :] < t_out[:, :, None]) & hitb[:, :, None])
    pscore = torch.where(hitb, anc.sum(1, dtype=torch.int32), 0)
    best = pscore.max(dim=1).values
    winner = hitb & (pscore == best[:, None]) & (best[:, None] > 0)
    tin_u = torch.where(winner, t_in, _I32_MAX).min(dim=1).values
    tin_v = torch.where(winner, t_in, -2).max(dim=1).values
    ca = ((tin[None, :] <= tin_u[:, None]) & (tin_u[:, None] < tout[None, :])
          & (tin[None, :] <= tin_v[:, None])
          & (tin_v[:, None] < tout[None, :]))
    d = torch.where(ca, depth[None, :], -1)
    assigned = torch.where(best > 0, d.argmax(dim=1), 0)   # first maximum
    nvalid = valid.sum(dim=1, dtype=torch.int32)
    thr = torch.tensor(confidence_threshold, dtype=torch.float32,
                       device=nvalid.device)
    below = best.to(torch.float32) < thr * nvalid.to(torch.float32)
    taxon = torch.where(below | (nvalid == 0), 0, assigned)
    return taxon.to(torch.int32), best.to(torch.int32), nvalid


def score_reads_tin(hit, t_in, t_out, valid, tin, tout, depth,
                    confidence_threshold: float):
    """Same contract as :func:`score_reads_tin_plain`: the plain version
    for CPU tensors, kernel K3 for CUDA tensors."""
    dev = _build.dispatch_device(hit, t_in, t_out, valid, tin, tout, depth)
    if dev is None:
        return score_reads_tin_plain(hit, t_in, t_out, valid, tin, tout,
                                     depth, confidence_threshold)
    _build.check(hit, torch.int32, ndim=2, name="hit")
    B, R = hit.shape
    for t, name in ((t_in, "t_in"), (t_out, "t_out")):
        _build.check(t, torch.int32, shape=(B, R), name=name)
    _build.check(valid, torch.bool, shape=(B, R), name="valid")
    T1 = tin.shape[0]
    for t, name in ((tin, "tin"), (tout, "tout"), (depth, "depth")):
        _build.check(t, torch.int32, shape=(T1,), name=name)
    if R > MAX_PROBES:
        raise NotImplementedError(
            f"{R} probes a read exceed kernel K3's {MAX_PROBES}: long reads "
            "need the ranked pscore (ROADMAP B11)")
    if T1 > MAX_TAXA:
        raise NotImplementedError(
            f"{T1} taxa exceed the direct LCA scan's {MAX_TAXA}: binary "
            "lifting is not ported yet (ROADMAP B12)")
    if R == 0:
        raise ValueError("score_reads_tin needs at least one probe a read")
    taxon = torch.empty(B, dtype=torch.int32, device=dev)
    best = torch.empty_like(taxon)
    nvalid = torch.empty_like(taxon)
    _build.launch("pangea_score_tin", dev, hit.data_ptr(), t_in.data_ptr(),
                  t_out.data_ptr(), valid.data_ptr(), B, R, tin.data_ptr(),
                  tout.data_ptr(), depth.data_ptr(), T1,
                  float(confidence_threshold), taxon.data_ptr(),
                  best.data_ptr(), nvalid.data_ptr())
    score_reads_tin.launches += 1
    return taxon, best, nvalid


score_reads_tin.launches = 0
