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

On a card both kernels take the queries routed: :func:`rowprobe_route`
(``csrc/bucket_sort.cu`` ``pangea_rowprobe_route``, K9's counting pass with
the row rule) orders them by their row's 32-row tile as records (query
index, row, rem, 1), and a block of either kernel stages only the rows its
run of records reaches (:func:`rowprobe_plan`, :func:`rowprobe_passes`).
:func:`rowprobe_routed_plain` is the probe of those records.

Lanes follow the port's rule (``kernels/lookup.py``): uint32 values live in
int32 tensors as bit patterns. Row numbers follow :func:`row_in`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .lookup import M32, narrow, widen

_PLAIN_CHUNK = 1 << 16            # queries a plain step
_ONEHOT_ELEMS = 1 << 24           # one-hot entries a plain product step
# The routed kernels' geometry, as the CUDA sources fix it: a routing tile
# (bucket_sort.cu kRouteTile) and its most keys (2^kRouteKeyBits); K12's
# k-tile of TILE_ROWS rows, the least key (shift 5); the records a K11 or
# K12 block takes (common.cuh kRun), the K12 step (rowprobe_onehot.cu
# kQueries) and the table bytes a block stages at once, at least one key's.
ROUTE_TILE = 2048
ROUTE_KEY_BITS = 11
TILE_ROWS = 32
RUN = 2048
STEP = 64
WINDOW_BYTES = 64 << 10
SMEM_BLOCK = 232_448              # an H100 block's opt-in shared memory


class RowprobePlan(NamedTuple):
    """The routed probe's key shift (key = row >> shift), its keys, and the
    keys a block stages at once."""
    shift: int
    keys: int
    window_keys: int


def rowprobe_plan(nb: int, w: int) -> RowprobePlan:
    """The routing pass's key is the row's 32-row tile (shift 5), coarsened
    to the least shift that leaves at most 2^ROUTE_KEY_BITS keys; a block
    stages as many whole keys as WINDOW_BYTES holds at 8W bytes a row, and
    at least one."""
    shift = 5
    while (nb - 1) >> shift >= 1 << ROUTE_KEY_BITS:
        shift += 1
    key_bytes = (8 * w) << shift
    return RowprobePlan(shift, ((nb - 1) >> shift) + 1,
                        max(1, WINDOW_BYTES // key_bytes))


def rowprobe_smem_bytes(plan: RowprobePlan, w: int, onehot: bool) -> int:
    """Dynamic shared memory of a K11 (or K12) block: the run's records,
    K12's joined rows, and a window of rows."""
    lanes = 2 * w
    joined = STEP * (lanes + (8 - lanes) % 32) * 4 if onehot else 0
    return 16 * RUN + joined + ((plan.window_keys << plan.shift) * lanes * 4)


def route_scratch(n: int, keys: int) -> int:
    """Int32 entries of the routing pass's key counts: a row a tile of
    ROUTE_TILE queries, then the keys' totals."""
    return (-(-n // ROUTE_TILE) + 1) * keys


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


def rowprobe_route_plain(b, rem, nb: int):
    """Plain version of the routing pass: (records, totals). records: int32
    [N, 4] (query index, row, rem, 1) ordered by the key row_in(b) >> shift
    at :func:`rowprobe_plan`'s shift (a stable sort); totals: int32 [keys],
    the queries of each key."""
    plan = rowprobe_plan(nb, 1)
    keys = row_in(b, nb) >> plan.shift
    perm = torch.sort(keys, stable=True).indices
    records = torch.stack([perm.to(torch.int32),
                           row_in(b, nb)[perm].to(torch.int32), rem[perm],
                           torch.ones_like(rem)], dim=1)
    return records, torch.bincount(keys, minlength=plan.keys).to(torch.int32)


def rowprobe_routed_plain(table, records):
    """The probe of routed records: int32 [N], at each record's query index
    the wrapping uint32 sum of its row's payload lanes whose rem lane
    equals its rem."""
    out = torch.empty(records.shape[0], dtype=torch.int32,
                      device=records.device)
    for i in range(0, records.shape[0], _PLAIN_CHUNK):
        r = records[i:i + _PLAIN_CHUNK]
        out[r[:, 0].long()] = _match_sum(widen(table[r[:, 1].long()]),
                                         r[:, 2])
    return out


def rowprobe_passes(rows, nb: int, plan: RowprobePlan, run: int = RUN):
    """The passes of the routed kernels' blocks over records whose rows
    (int64 numpy [N]) are in routed order, as ``common.cuh`` ``row_pass``
    cuts them: (first, end, row0, rows) a pass, block by block (runs of
    ``run`` records). A pass opens at a record's key and ends before the
    first record of its run window_keys keys on; it stages the rows of the
    keys from its first record's to its last's, cut at NB."""
    keys = np.asarray(rows) >> plan.shift
    passes = []
    for r0 in range(0, keys.size, run):
        r1 = min(keys.size, r0 + run)
        i = r0
        while i < r1:
            end = i + int(np.searchsorted(keys[i:r1],
                                          keys[i] + plan.window_keys))
            row0 = int(keys[i]) << plan.shift
            passes.append((i, end, row0, min(
                nb, (int(keys[end - 1]) + 1) << plan.shift) - row0))
            i = end
    return passes


def onehot_visits(rows, nb: int, plan: RowprobePlan) -> int:
    """The (m-tile, k-tile) products K12 runs on records whose rows (int64
    numpy [N]) are in routed order: an m-tile is 16 consecutive records of
    a STEP-record step of a pass, and it visits each distinct k-tile of its
    rows once."""
    rows = np.asarray(rows)
    visits = 0
    for i, end, _, _ in rowprobe_passes(rows, nb, plan):
        for m in range(i, end, 16):
            visits += np.unique(rows[m:min(end, m + 16)] // TILE_ROWS).size
    return visits


def _check(table, b, rem) -> None:
    _build.check(table, torch.int32, ndim=2, name="table")
    _build.check(b, torch.int32, ndim=1, name="b")
    _build.check(rem, torch.int32, shape=b.shape, name="rem")
    if table.shape[1] % 2 or table.shape[0] < 1:
        raise ValueError(f"table {tuple(table.shape)} is not [NB, 2W]")


def rowprobe_route(b, rem, nb: int):
    """The queries routed by their row's tile, (records, totals) as
    :func:`rowprobe_route_plain` returns them: the plain version for CPU
    tensors, the routing pass (``csrc/bucket_sort.cu``, K9's tile counts,
    column scan and scatter with the row rule, tiles of ROUTE_TILE
    queries) for CUDA tensors; within a key the order is unspecified."""
    dev = _build.dispatch_device(b, rem)
    if dev is None:
        return rowprobe_route_plain(b, rem, nb)
    _build.check(b, torch.int32, ndim=1, name="b")
    _build.check(rem, torch.int32, shape=b.shape, name="rem")
    if not 1 <= nb < 2**31:
        raise ValueError(f"rowprobe_route: NB={nb}")
    plan = rowprobe_plan(nb, 1)
    n = b.numel()
    records = torch.empty((n, 4), dtype=torch.int32, device=dev)
    if n == 0:
        return records, torch.zeros(plan.keys, dtype=torch.int32,
                                    device=dev)
    counts = torch.empty(route_scratch(n, plan.keys), dtype=torch.int32,
                         device=dev)
    _build.launch("pangea_rowprobe_route", dev, b.data_ptr(),
                  rem.data_ptr(), n, nb, plan.shift, counts.data_ptr(),
                  records.data_ptr())
    rowprobe_route.launches += 1
    return records, counts[-plan.keys:]


rowprobe_route.launches = 0


def _routed(wrapper, table, b, rem, onehot: bool):
    """Route the queries, then launch the routed probe of ``wrapper``
    (rowprobe_smem or rowprobe_onehot) and count its launch."""
    name = f"pangea_{wrapper.__name__}"
    dev = table.device
    nb, w = table.shape[0], table.shape[1] // 2
    plan = rowprobe_plan(nb, w)
    if rowprobe_smem_bytes(plan, w, onehot) > SMEM_BLOCK:
        raise ValueError(f"{name}: a key's rows of table "
                         f"{tuple(table.shape)} pass a block's shared memory")
    out = torch.empty(b.shape, dtype=torch.int32, device=dev)
    if b.numel() == 0:
        return out
    records, _ = rowprobe_route(b, rem, nb)
    _build.launch(name, dev, table.data_ptr(), nb, w, plan.shift,
                  plan.window_keys, records.data_ptr(), b.numel(),
                  out.data_ptr())
    wrapper.launches += 1
    return out


def rowprobe_smem(table, b, rem):
    """The row probe: the plain version for CPU tensors; for CUDA tensors
    the routing pass, then kernel K11 (a block stages the rows its run of
    records reaches in shared memory and probes them there)."""
    dev = _build.dispatch_device(table, b, rem)
    if dev is None:
        return rowprobe_plain(table, b, rem)
    _check(table, b, rem)
    return _routed(rowprobe_smem, table, b, rem, False)


rowprobe_smem.launches = 0


def rowprobe_onehot(table, b, rem):
    """The row probe as a one-hot product: the plain version for CPU
    tensors; for CUDA tensors the routing pass, then kernel K12
    (``mma.sync`` on u8 byte planes over the k-tiles its m-tiles' rows lie
    in), which takes 2W a multiple of 8 up to 128."""
    dev = _build.dispatch_device(table, b, rem)
    if dev is None:
        return rowprobe_onehot_plain(table, b, rem)
    _check(table, b, rem)
    if table.shape[1] % 8 or table.shape[1] > 128:
        raise ValueError(f"K12 takes 2W a multiple of 8 up to 128, got "
                         f"{table.shape[1]}")
    return _routed(rowprobe_onehot, table, b, rem, True)


rowprobe_onehot.launches = 0
