"""The row gather of the Pallas DMA experiments (B16).

Counterpart of the Pallas kernels of ``experiments/mb_gather2.py``-``5.py``:
each computes ``table[idx]`` with per-row DMAs kept ``depth`` deep, a grid
step taking ``chunk`` indices. :func:`row_gather_plain` is that function by
advanced indexing. Kernel K13 (``csrc/row_gather.cu``) translates the DMA
ring: :func:`row_gather` stages each row through shared memory and stores it
from registers (the VMEM-output kernels: ``mb_gather2`` ``pallas_gather``,
``mb_gather3`` ``make_pallas_gather``, ``mb_gather5`` ``variant_vmem_out``),
:func:`row_gather_direct` bounces each row through shared memory with bulk
copies both ways (``mb_gather5`` ``variant_hbm2hbm``), and
:func:`block_copy` copies one block of ``rows`` rows from a start read from
device memory (``mb_gather4``'s two DMA probes).

K13 moves bytes: a table of any dtype whose row is a multiple of 16 bytes.
Index i names the row start ``row_in(idx[i], NB, rows)`` (below 0 it counts
from the end; then it is clamped into [0, NB - rows], as XLA clamps the
reference's gather); its rows land at [i * rows, (i + 1) * rows) of the
output.
"""
from __future__ import annotations

import torch

from . import _build
from .rowprobe import row_in


def row_gather_plain(table, idx, rows: int = 1):
    """table [NB, ...] any dtype, idx int [n]: [n * rows, ...], the rows
    table[idx[i] + r] for r < rows, index by index."""
    start = row_in(idx, table.shape[0], rows)
    if rows != 1:
        start = (start[:, None] + torch.arange(rows, device=idx.device)
                 ).reshape(-1)
    return table[start]


def _gather_kernel(dev, table, idx, depth: int, chunk: int, direct: bool,
                   rows: int):
    """K13 on CUDA tensors: the output of ``row_gather_plain``."""
    _build.check(idx, torch.int32, ndim=1, name="idx")
    if not table.is_contiguous() or table.dim() < 1:
        raise ValueError("table: kernel takes a contiguous [NB, ...] tensor")
    row_bytes = table[0].numel() * table.element_size()
    if row_bytes == 0 or row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"K13 copies 16-byte-aligned rows of a multiple of "
                         f"16 bytes; a row here has {row_bytes}")
    if not 1 <= rows <= table.shape[0] or depth < 1 or chunk < 1:
        raise ValueError(f"rows={rows}, depth={depth}, chunk={chunk} for "
                         f"{table.shape[0]} table rows")
    out = torch.empty((idx.numel() * rows, *table.shape[1:]),
                      dtype=table.dtype, device=dev)
    _build.launch("pangea_row_gather", dev, table.data_ptr(), table.shape[0],
                  row_bytes, rows, idx.data_ptr(), idx.numel(), depth, chunk,
                  int(direct), out.data_ptr())
    return out


def row_gather(table, idx, *, depth: int, chunk: int, direct: bool = False,
               rows: int = 1):
    """The row gather: the plain version for CPU tensors, kernel K13 for
    CUDA tensors, block by block of ``chunk`` indices with ``depth`` row
    copies in flight; staged through registers, or ``direct`` (the form
    :func:`row_gather_direct` counts)."""
    if direct:
        return row_gather_direct(table, idx, depth=depth, chunk=chunk,
                                 rows=rows)
    dev = _build.dispatch_device(table, idx)
    if dev is None:
        return row_gather_plain(table, idx, rows)
    out = _gather_kernel(dev, table, idx, depth, chunk, False, rows)
    row_gather.launches += 1
    return out


row_gather.launches = 0


def row_gather_direct(table, idx, *, depth: int, chunk: int, rows: int = 1):
    """The row gather with K13's direct form on CUDA tensors: each row
    leaves its shared-memory slot by a bulk copy, never through
    registers."""
    dev = _build.dispatch_device(table, idx)
    if dev is None:
        return row_gather_plain(table, idx, rows)
    out = _gather_kernel(dev, table, idx, depth, chunk, True, rows)
    row_gather_direct.launches += 1
    return out


row_gather_direct.launches = 0


def block_copy(x, start, rows: int):
    """x[s:s + rows] for s = start[0], read from the tensor ``start`` (int32
    [1]) where the copy runs: K13 with one index of ``rows`` rows on CUDA
    tensors."""
    dev = _build.dispatch_device(x, start)
    if dev is None:
        return row_gather_plain(x, start, rows)
    _build.check(start, torch.int32, shape=(1,), name="start")
    out = _gather_kernel(dev, x, start, 1, 1, False, rows)
    block_copy.launches += 1
    return out


block_copy.launches = 0
