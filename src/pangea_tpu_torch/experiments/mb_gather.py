"""The Pallas row gathers of ``experiments/mb_gather2.py``-``5.py`` on the
port, as named variants at the scripts' own shapes.

    python -m pangea_tpu_torch.experiments.mb_gather [--device cuda|cpu]
        [--nb 524288] [--queries N]

The table is [NB, 64] uint32 (256 B rows, 134.2 MB at NB = 2^19), the
scripts' shape; the indices are uniform in [0, NB). Variants (K13 of
``kernels/gather.py``; ``(depth, chunk)`` as in the script):

  gather2_d16_c512            mb_gather2.py:119 pallas_gather, 2^20 rows
  gather3_d{8,16}_c4096,      mb_gather3.py:93 make_pallas_gather, 2^20
    gather3_d32_c8192
  gather4_static, _dynamic    mb_gather4.py:86/:106: one DMA of 8 rows of a
                              [16, 128] float32 array at row 0 / at row 4
                              read from memory
  gather5_hbm2hbm_d16_c4096,  mb_gather5.py:36 variant_hbm2hbm (K13
    gather5_hbm2hbm_d64_c8192 direct), 2^19 rows
  gather5_vmem_out_d16_c4096  mb_gather5.py:88 variant_vmem_out, 2^19

Each line gives ``ms`` (CUDA events after a warm-up on a card, the host
clock with ``--device cpu``), ``rows_per_sec``, ``mismatches`` against
``row_gather_plain`` (gather4: against the slice the script checks), and
``yardstick_ms``, one PyTorch call for the same function
(``torch.index_select``; gather4: ``x.narrow(0, i, 8).clone()``), timed
here and used nowhere in the port, with ``vs_yardstick`` = ms /
yardstick_ms, and ``bound_ms``, the rows read and written once plus 4 B an
index over the H100's 3.35 TB/s. ``--queries`` caps the indices of every
variant; the last line is the process's kernel launches.

The scripts' XLA-only sections (row-width, table-size and locality sweeps,
``lax.sort`` and element-``take`` costs) measure XLA, not a TPU kernel, and
have no counterpart here.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..utils import device_from
from . import device_name, emit, step_ms

D = 64                            # 256 B rows
NB = (134 * 1024 * 1024) // (4 * D)
NB = 1 << (NB.bit_length() - 1)   # 2^19
# name -> (indices, depth, chunk, direct); gather4's are block copies.
VARIANTS = {
    "gather2_d16_c512": (1 << 20, 16, 512, False),
    "gather3_d8_c4096": (1 << 20, 8, 4096, False),
    "gather3_d16_c4096": (1 << 20, 16, 4096, False),
    "gather3_d32_c8192": (1 << 20, 32, 8192, False),
    "gather4_static": (0, None, None, None),
    "gather4_dynamic": (4, None, None, None),
    "gather5_hbm2hbm_d16_c4096": (1 << 19, 16, 4096, True),
    "gather5_hbm2hbm_d64_c8192": (1 << 19, 64, 8192, True),
    "gather5_vmem_out_d16_c4096": (1 << 19, 16, 4096, False),
}
BLOCK_ROWS = 8                    # mb_gather4's DMA: rows [i, i + 8)
HBM_BYTES_PER_S = 3.35e12         # an H100 SXM's device memory


def make_world(seed: int = 0, nb: int = NB, n: int = 1 << 20):
    """(table uint32 [nb, D], idx int32 [n]) from one generator: the table
    as the scripts draw it, then the indices."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 2**32, size=(nb, D), dtype=np.uint32)
    idx = rng.integers(0, nb, size=n).astype(np.int32)
    return table, idx


def world_tensors(world, device):
    """The world as the port's tensors: the table int32 (uint32 bit
    patterns) and the indices, on ``device``."""
    import torch
    table, idx = world
    return (torch.from_numpy(table.view(np.int32)).to(device),
            torch.from_numpy(idx).to(device))


def block_world():
    """mb_gather4's x: arange(16 * 128) float32 as [16, 128]."""
    return np.arange(16 * 128, dtype=np.float32).reshape(16, 128)


def run_variant(name: str, table, idx, x, device) -> dict:
    """One variant: check against its reference, time it and its
    yardstick; returns its line."""
    import torch

    from ..kernels import block_copy, row_gather, row_gather_plain
    n, depth, chunk, direct = VARIANTS[name]
    if name.startswith("gather4"):
        start = torch.tensor([n], dtype=torch.int32, device=device)
        got = block_copy(x, start, BLOCK_ROWS)
        mism = int((got != x[n:n + BLOCK_ROWS]).sum())

        def kernel():
            return block_copy(x, start, BLOCK_ROWS)

        def yardstick():
            return x.narrow(0, n, BLOCK_ROWS).clone()
        rows, shape, table_ = BLOCK_ROWS, list(x.shape), x
    else:
        ix = idx[:n]
        got = row_gather(table, ix, depth=depth, chunk=chunk, direct=direct)
        mism = int((got != row_gather_plain(table, ix)).sum())

        def kernel():
            return row_gather(table, ix, depth=depth, chunk=chunk,
                              direct=direct)

        def yardstick():
            return torch.index_select(table, 0, ix)
        rows, shape, table_ = ix.numel(), list(table.shape), table
    ms, yardstick_ms = step_ms(kernel, device), step_ms(yardstick, device)
    row_bytes = table_[0].numel() * table_.element_size()
    indices = 1 if name.startswith("gather4") else rows
    nbytes = 2 * rows * row_bytes + 4 * indices
    return {"variant": name, "device": device_name(device), "table": shape,
            "rows": rows, "depth": depth, "chunk": chunk, "direct": direct,
            "ms": ms, "rows_per_sec": rows / ms * 1e3, "mismatches": mism,
            "yardstick_ms": yardstick_ms, "vs_yardstick": ms / yardstick_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m "
                                "pangea_tpu_torch.experiments.mb_gather")
    p.add_argument("--device", default="cuda")
    p.add_argument("--nb", type=int, default=NB)
    p.add_argument("--queries", type=int, default=None,
                   help="cap on each variant's indices")
    args = p.parse_args(argv)
    device = device_from(args.device)

    import torch

    from ..kernels import kernel_launches
    table, idx = world_tensors(make_world(nb=args.nb), device)
    if args.queries is not None:
        idx = idx[:args.queries]
    x = torch.from_numpy(block_world()).to(device)
    bad = 0
    for name in VARIANTS:
        line = run_variant(name, table, idx, x, device)
        emit(**line)
        bad += line["mismatches"]
    emit(kernel_launches=kernel_launches())
    if bad:
        print(f"{bad} mismatches", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
