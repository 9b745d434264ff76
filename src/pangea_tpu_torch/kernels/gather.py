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
output. :func:`gather_plan` sizes K13's launch to the card: ``depth`` and
``chunk`` set a lane's ring slots and a block's step, never the grid.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

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


SMEM_OPTIN = 232_448     # an H100 block's opt-in shared memory, bytes
SM_RESERVED = 1024       # shared memory the SM keeps back for each block
SM_THREADS, SM_BLOCKS = 2048, 32
WARPS = 4                # warps a block at most
SM_WARPS = 8             # warps an SM: the knee of kernels.gather_sweep
ISSUERS = 2048           # issuing lanes the card needs (Little's law)
BARRIER_BYTES = 8        # a slot's mbarrier


class GatherPlan(NamedTuple):
    """K13's launch: ``grid`` blocks of ``warps`` warps; each warp has
    ``slots`` ring slots, owned by its first ``lanes`` lanes (slots //
    lanes each); ``smem`` shared bytes a block."""
    grid: int
    warps: int
    lanes: int
    slots: int
    smem: int


@functools.lru_cache(maxsize=256)
def gather_plan(n: int, depth: int, chunk: int, slot_bytes: int, sms: int,
                smem_limit: int) -> GatherPlan:
    """The launch of K13 for n indices of slot_bytes-byte copies on a card
    of ``sms`` SMs with ``smem_limit`` opt-in shared bytes a block.

    Every lane of a warp issues its own copies, one index a lane in runs of
    ``lanes`` = min(32, n, chunk) (a block steps through its share
    ``chunk`` indices at a time; fewer lanes where one slot each does not
    fit). A lane owns ceil(depth / lanes) slots, so a warp keeps ``depth``
    copies in flight, cut to fit a block, then halved while the card would
    hold fewer than ISSUERS issuing lanes. A block has up to WARPS warps,
    and an SM SM_WARPS (more where lanes are few, so that the card has
    ISSUERS), as far as its shared memory holds them; the grid is those
    blocks on every SM, capped by the work, so that each block's share of
    the ceil(n / lanes) runs is even. Raises where one slot does not
    fit."""
    if n < 0 or depth < 1 or chunk < 1 or slot_bytes < 16:
        raise ValueError(f"n={n}, depth={depth}, chunk={chunk}, "
                         f"slot_bytes={slot_bytes}")
    per_slot = slot_bytes + BARRIER_BYTES
    if per_slot > smem_limit:
        raise ValueError(f"a {slot_bytes}-byte copy does not fit "
                         f"{smem_limit} bytes of shared memory")
    lanes = min(32, max(n, 1), chunk, smem_limit // per_slot)
    runs = -(-n // lanes)
    sm_warps = max(SM_WARPS, -(-ISSUERS // (sms * lanes)))
    per_lane = min(-(-depth // lanes), smem_limit // (lanes * per_slot))
    while True:
        slots = lanes * per_lane
        warps = max(1, min(WARPS, smem_limit // (slots * per_slot), runs))
        smem = warps * slots * per_slot
        per_sm = min((smem_limit + SM_RESERVED) // (smem + SM_RESERVED),
                     SM_THREADS // (32 * warps), SM_BLOCKS,
                     -(-sm_warps // warps))
        blocks = min(sms * per_sm, -(-runs // warps))
        if per_lane == 1 or blocks * warps * lanes >= min(ISSUERS, n):
            break
        per_lane //= 2
    grid = -(-runs // -(-runs // blocks)) if runs else 0
    return GatherPlan(grid, warps, lanes, slots, smem)


def _gather_kernel(dev, table, idx, depth: int, chunk: int, direct: bool,
                   rows: int):
    """K13 on CUDA tensors: the output of ``row_gather_plain``."""
    _build.check(idx, torch.int32, ndim=1, name="idx")
    if not table.is_contiguous() or table.dim() < 1:
        raise ValueError("table: kernel takes a contiguous [NB, ...] tensor")
    row_bytes = math.prod(table.shape[1:]) * table.element_size()
    if row_bytes == 0 or row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"K13 copies 16-byte-aligned rows of a multiple of "
                         f"16 bytes; a row here has {row_bytes}")
    if not 1 <= rows <= table.shape[0] or depth < 1 or chunk < 1:
        raise ValueError(f"rows={rows}, depth={depth}, chunk={chunk} for "
                         f"{table.shape[0]} table rows")
    plan = gather_plan(idx.numel(), depth, chunk, rows * row_bytes,
                       _build.sm_count(dev.index), SMEM_OPTIN)
    out = torch.empty((idx.numel() * rows, *table.shape[1:]),
                      dtype=table.dtype, device=dev)
    _build.launch("pangea_row_gather", dev, table.data_ptr(), table.shape[0],
                  row_bytes, rows, idx.data_ptr(), idx.numel(), chunk,
                  int(direct), plan.grid, plan.warps, plan.lanes, plan.slots,
                  out.data_ptr())
    return out


def row_gather(table, idx, *, depth: int, chunk: int, direct: bool = False,
               rows: int = 1):
    """The row gather: the plain version for CPU tensors, kernel K13 for
    CUDA tensors (``depth`` row copies in flight a warp, a block's step of
    ``chunk`` indices: :func:`gather_plan`); staged through registers, or
    ``direct`` (the form :func:`row_gather_direct` counts)."""
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


@functools.lru_cache(maxsize=64)
def _block_geometry(shape, dtype, rows: int):
    """(row bytes, output shape) of a block copy of ``rows`` rows of a
    [NB, ...] table of ``shape`` and ``dtype``; raises where K13 cannot
    copy it."""
    row_bytes = math.prod(shape[1:]) * dtype.itemsize
    if len(shape) < 1 or row_bytes == 0 or row_bytes % 16:
        raise ValueError(f"K13 copies 16-byte-aligned rows of a multiple of "
                         f"16 bytes; a row of {tuple(shape)} has {row_bytes}")
    if not 1 <= rows <= shape[0]:
        raise ValueError(f"rows={rows} for {shape[0]} table rows")
    return row_bytes, (rows, *shape[1:])


def block_copy(x, start, rows: int):
    """x[s:s + rows] for s = start[0], read from the tensor ``start`` (int32
    [1]) where the copy runs: K13 with one index of ``rows`` rows on CUDA
    tensors, launched by ``pangea_block_copy`` with the plan
    :func:`gather_plan` gives one index (one block of one warp, one lane
    and one slot), its geometry cached by shape."""
    dev = _build.dispatch_device(x, start)
    if dev is None:
        return row_gather_plain(x, start, rows)
    _build.check(start, torch.int32, shape=(1,), name="start")
    table = x.data_ptr()
    if table % 16 or not x.is_contiguous():
        raise ValueError("x: K13 takes a contiguous, 16-byte-aligned table")
    shape = x.shape
    row_bytes, out_shape = _block_geometry(shape, x.dtype, rows)
    out = x.new_empty(out_shape)
    _build.launch("pangea_block_copy", dev, table, shape[0], row_bytes, rows,
                  start.data_ptr(), out.data_ptr())
    block_copy.launches += 1
    return out


block_copy.launches = 0
