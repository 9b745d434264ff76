"""The row probe of ``experiments/mb_pallas.py`` on the port.

    python -m pangea_tpu_torch.experiments.mb_pallas [--device cuda|cpu]
        [--seed 0] [--nb 16384] [--queries 524288]

The world is the reference's ``make_world``: a [NB, 2W] uint32 table, N row
numbers and remainders, about half of them planted in their row. Variants,
one JSON line each, every one on all N queries:

  plain -- ``rowprobe_plain``, the reference's ``xla_lookup``;
  take  -- K11 (``rowprobe_smem``), for ``take_lookup``: the queries
           routed by table tile (``rowprobe_route``), then each block holds
           the rows its run of queries reaches in shared memory;
  oneh  -- K12 (``rowprobe_onehot``), for ``oneh_lookup``: the same routing,
           then the one-hot product on the tensor cores over only the
           32-row tiles the queries reach (dense, as the TPU ran it, 2 N NB
           4 (2W) operations: 8.8e12 at the defaults, 4.4 ms at the H100's
           int8 peak; over those tiles about 1.7e10).

A line gives ``step_ms`` (CUDA events after a warm-up on a card, the host
clock with ``--device cpu``), ``rows_per_sec``, ``mismatches`` against
``plain`` and the variant's ``launches``; the last line is the process's
kernel launches.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import device_from
from . import device_name, emit, step_ms

NB = 16384
W = 64               # q8 W=64: 64 rem + 64 payload lanes
N = 524288           # the reference bench's probes a step


def make_world(seed: int = 0, nb: int = NB, n: int = N, w: int = W):
    """The reference's ``make_world`` as numpy arrays: (table uint32 [nb,
    2w], b int32 [n], rem uint32 [n]), from the same generator calls in
    the same order."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(nb, 2 * w), dtype=np.uint32)
    b = rng.integers(0, nb, size=n, dtype=np.int32)
    rem = rng.integers(0, 2**31, size=n, dtype=np.uint32)
    lane = rng.integers(0, w, size=n)
    hit = rng.random(n) < 0.5
    t = table.copy()
    t[b[hit], lane[hit]] = rem[hit]
    return t, b, rem


def world_tensors(world, device):
    """The world as the port's int32 tensors (uint32 bit patterns)."""
    import torch
    t, b, rem = world
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
                 .to(device) for a in (t, b, rem))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "pangea_tpu_torch.experiments.mb_pallas")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--nb", type=int, default=NB)
    p.add_argument("--queries", type=int, default=N)
    args = p.parse_args(argv)
    device = device_from(args.device)

    from ..kernels import (kernel_launches, rowprobe_onehot, rowprobe_plain,
                           rowprobe_smem)
    table, b, rem = world_tensors(
        make_world(args.seed, args.nb, args.queries), device)
    n = b.numel()
    want = rowprobe_plain(table, b, rem)
    for name, fn in (("plain", rowprobe_plain), ("take", rowprobe_smem),
                     ("oneh", rowprobe_onehot)):
        launches0 = kernel_launches()
        mism = int((fn(table, b, rem) != want).sum())
        ms = step_ms(lambda: fn(table, b, rem), device)
        launched = {k: v - launches0[k] for k, v in kernel_launches().items()
                    if v != launches0[k]}
        emit(variant=name, device=device_name(device), table=list(
            table.shape), queries=n, step_ms=ms, rows_per_sec=n / ms * 1e3,
             mismatches=mism, launches=launched)
        if mism:
            print(f"{name}: {mism} mismatches against plain",
                  file=sys.stderr)
            return 1
    emit(kernel_launches=kernel_launches())
    return 0


if __name__ == "__main__":
    sys.exit(main())
