"""Sweep K4's launch plans on the card, at the std paths' shapes.

    PYTHONPATH=src python -m pangea_tpu_torch.kernels.lookup_sweep [--deep DIR]

Cases: K4 and its sorted form (given K9's order) on the wide std world
of ``chip_smoke.py`` phase 7 (4,259,840 probes on the 131,072 x 192
table, W = 32), K4 on the k=31 packed world (W = 16) and, with ``--deep
DIR``, K4 and its sorted form on the deep world's std table (4,194,304
packed rows, W = 16; 8,519,680 probes), the worlds of ``ab_timing``.
Every plan of batch (the probes whose key loads a group issues together:
2, 4), (warps a block, blocks an SM) of SHAPES and L2 policy mode (0-2,
``StdPlan``) is checked against ``lookup_std_plain``, bit for bit,
and timed (``experiments.step_ms``: CUDA events over CALLS back-to-back
launches, the median of 10 samples). Each plan is one JSON line; the last
line gives, for each case, ``std_plan``'s choice and its time, and the
fastest plans. It launches K4 past the wrappers, so it counts no
launches. A card is needed; it exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import _build
from .lookup import (STASH_ROWS, STASH_SMEM_MAX, StdPlan, _std_kernel,
                     bucket_sort, lookup_std_plain, std_plan)

CALLS = 10
SHAPES = ((8, 2), (8, 3), (8, 4), (8, 8), (4, 8), (4, 16))  # (warps, an SM)


def plans(n: int, ways: int, stash_cols: int, sms: int):
    """Every plan swept for n probes, with its blocks an SM."""
    spec = ways if ways in (16, 32) else 0
    smem = STASH_ROWS * 4 * stash_cols
    smem = smem if smem <= STASH_SMEM_MAX else 0
    for batch in (2, 4):
        for warps, per_sm in SHAPES:
            grid = min(sms * per_sm, -(-n // (warps * 32)))
            for l2 in (0, 1, 2):
                yield per_sm, StdPlan(grid, warps, batch, spec, l2, smem)


def cases(torch, dev, deep: Path | None):
    """(name, flat probes, (fused, stash, ways), K9's order or None)."""
    from .ab_timing import PACKED, WIDE, bench_world, deep_std, probes
    di, b1, b2 = bench_world(torch, dev, 16384, **WIDE)
    flat = probes(torch, b1, b2, WIDE["k"], WIDE["w"])
    tab = (di.fused, di.stash, di.cfg.ways)
    yield "wide", flat, tab, None
    yield "wide_sorted", flat, tab, bucket_sort(*flat, di.fused.shape[0])
    pdi, _, _ = bench_world(torch, dev, 1, **PACKED)
    yield ("packed", probes(torch, b1, b2, PACKED["k"], PACKED["w"]),
           (pdi.fused, pdi.stash, pdi.cfg.ways), None)
    if deep is not None:
        ddi, dflat = deep_std(torch, dev, deep)
        dtab = (ddi.fused, ddi.stash, ddi.cfg.ways)
        yield "deep", dflat, dtab, None
        yield ("deep_sorted", dflat, dtab,
               bucket_sort(*dflat, ddi.fused.shape[0]))


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--deep", type=Path, default=None,
                    help="also sweep the deep std table, its index in DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lookup_sweep: no CUDA device", file=sys.stderr)
        return 1
    from ..experiments import step_ms
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(0)
    summary = {"device": torch.cuda.get_device_name(dev), "cases": []}
    bad = 0
    for name, flat, tab, order in cases(torch, dev, args.deep):
        n = flat[0].numel()
        want = lookup_std_plain(*flat, *tab)

        def run(plan):
            return _std_kernel(dev, *flat, *tab, order, None, plan=plan)
        lines = []
        for per_sm, plan in plans(n, tab[2], tab[1].shape[1], sms):
            mism = sum(int((a != b).sum()) for a, b in zip(want, run(plan)))
            ms = step_ms(lambda: run(plan), dev, CALLS)
            line = {"case": name, "n": n, **plan._asdict(),
                    "blocks_per_sm": per_sm, "ms": ms, "mismatches": mism}
            bad += mism
            lines.append(line)
            print(json.dumps(line), flush=True)
        chosen = std_plan(n, tab[2], tab[1].shape[1], order is not None,
                          sms)
        summary["cases"].append({
            "case": name, "n": n, "plan": chosen._asdict(),
            "plan_ms": step_ms(lambda: run(chosen), dev, CALLS),
            "fastest": [{k: b[k] for k in ("batch", "warps",
                                           "blocks_per_sm", "l2", "ms")}
                        for b in sorted(lines, key=lambda x: x["ms"])[:5]]})
    print(json.dumps(summary))
    if bad:
        print(f"lookup_sweep: {bad} mismatches", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
