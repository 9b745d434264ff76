"""The row probe of the Pallas lookup experiments (B16).

Counterpart of ``experiments/mb_pallas.py``: :func:`rowprobe_plain` is its
``xla_lookup`` (:68), the function that both of its Pallas kernels compute.
For each query, row ``b`` of a ``[NB, 2W]`` table gives W rem lanes and W
payload lanes; the output is the wrapping uint32 sum of the payload lanes
whose rem lane equals ``rem``. :func:`rowprobe_smem` (kernel K11,
``csrc/rowprobe_smem.cu``) replaces ``take_lookup`` (:83), whose table stays
resident in VMEM; :func:`rowprobe_onehot` (kernel K12,
``csrc/rowprobe_onehot.cu``) replaces ``oneh_lookup`` (:118), whose rows come
from a one-hot x table product on the matrix unit, and
:func:`rowprobe_onehot_plain` repeats that product step by step.

Lanes follow the port's rule (``kernels/lookup.py``): uint32 values live in
int32 tensors as bit patterns. Row numbers follow :func:`row_in`.
"""
from __future__ import annotations

import torch

from . import _build
from .lookup import M32, narrow, widen

_PLAIN_CHUNK = 1 << 16            # queries a plain step
_ONEHOT_ELEMS = 1 << 24           # one-hot entries a plain product step


def row_in(i: torch.Tensor, nb: int, rows: int = 1) -> torch.Tensor:
    """int64 row starts that indices i name in a table of nb rows, as
    NumPy-style indexing under XLA takes them: below 0 they count from the
    end, then they are clamped into [0, nb - rows]."""
    i = i.long()
    return torch.where(i < 0, i + nb, i).clamp(0, nb - rows)


def _match_sum(rows: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
    """int32 [n]: wrapping sum of the payload lanes of int64 rows [n, 2W]
    (uint32 values) whose rem lane equals rem."""
    W = rows.shape[1] // 2
    hit = rows[:, :W] == widen(rem)[:, None]
    return narrow(torch.where(hit, rows[:, W:], 0).sum(dim=1))


def rowprobe_plain(table, b, rem):
    """xla_lookup: table int32 [NB, 2W], b int32 [N], rem int32 [N];
    returns int32 [N], the wrapping uint32 sum of row b's payload lanes
    [W, 2W) where its rem lanes [0, W) equal rem."""
    nb = table.shape[0]
    out = torch.empty(b.shape, dtype=torch.int32, device=b.device)
    for i in range(0, b.numel(), _PLAIN_CHUNK):
        sl = slice(i, i + _PLAIN_CHUNK)
        out[sl] = _match_sum(widen(table[row_in(b[sl], nb)]), rem[sl])
    return out


def rowprobe_onehot_plain(table, b, rem):
    """``oneh_lookup``'s product repeated step by step: for a chunk of
    queries, the one-hot [m, NB] times the table's four byte planes [NB,
    4 * 2W], in float32, recombined into rows, then the probe of
    :func:`rowprobe_plain`. Exact: each product is one byte times 1. TF32
    would keep these values exact too; the product runs in full float32
    all the same (``torch.backends.cuda.matmul.allow_tf32`` is set False
    for the call)."""
    nb, lanes = table.shape
    t = widen(table)
    planes = torch.cat([((t >> (8 * p)) & 0xFF) for p in range(4)],
                       dim=1).to(torch.float32)            # [NB, 4 * 2W]
    step = max(1, _ONEHOT_ELEMS // nb)
    out = torch.empty(b.shape, dtype=torch.int32, device=b.device)
    cols = torch.arange(nb, device=b.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(0, b.numel(), step):
            sl = slice(i, i + step)
            onehot = (row_in(b[sl], nb)[:, None] == cols).to(torch.float32)
            by = (onehot @ planes).to(torch.int64)         # [m, 4 * 2W]
            rows = sum(by[:, p * lanes:(p + 1) * lanes] << (8 * p)
                       for p in range(4)) & M32
            out[sl] = _match_sum(rows, rem[sl])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def _check(table, b, rem) -> None:
    _build.check(table, torch.int32, ndim=2, name="table")
    _build.check(b, torch.int32, ndim=1, name="b")
    _build.check(rem, torch.int32, shape=b.shape, name="rem")
    if table.shape[1] % 2 or table.shape[0] < 1:
        raise ValueError(f"table {tuple(table.shape)} is not [NB, 2W]")


def rowprobe_smem(table, b, rem):
    """The row probe: the plain version for CPU tensors, kernel K11 (the
    table in slices of 128 KB, each held in one block's shared memory) for
    CUDA tensors."""
    dev = _build.dispatch_device(table, b, rem)
    if dev is None:
        return rowprobe_plain(table, b, rem)
    _check(table, b, rem)
    out = torch.empty(b.shape, dtype=torch.int32, device=dev)
    _build.launch("pangea_rowprobe_smem", dev, table.data_ptr(),
                  table.shape[0], table.shape[1] // 2, b.data_ptr(),
                  rem.data_ptr(), b.numel(), out.data_ptr())
    rowprobe_smem.launches += 1
    return out


rowprobe_smem.launches = 0


def rowprobe_onehot(table, b, rem):
    """The row probe as a one-hot product: the plain version for CPU
    tensors, kernel K12 (``mma.sync`` on u8 byte planes) for CUDA tensors,
    which takes 2W a multiple of 8 up to 128."""
    dev = _build.dispatch_device(table, b, rem)
    if dev is None:
        return rowprobe_onehot_plain(table, b, rem)
    _check(table, b, rem)
    if table.shape[1] % 8 or table.shape[1] > 128:
        raise ValueError(f"K12 takes 2W a multiple of 8 up to 128, got "
                         f"{table.shape[1]}")
    out = torch.empty(b.shape, dtype=torch.int32, device=dev)
    _build.launch("pangea_rowprobe_onehot", dev, table.data_ptr(),
                  table.shape[0], table.shape[1] // 2, b.data_ptr(),
                  rem.data_ptr(), b.numel(), out.data_ptr())
    rowprobe_onehot.launches += 1
    return out


rowprobe_onehot.launches = 0
