"""Sweep K2's and K4's launch plans on the card, at the main paths' shapes.

    PYTHONPATH=src python -m pangea_tpu_torch.kernels.lookup_sweep \\
        [--deep DIR] [--kernels k2,k4]

K2 cases (``quot_plan``): the q8 probe on the headline (524,288 probes,
k=21, w=8, on the 16,384 x 128 table) and its sorted form given K9's
order; config 4's q12 probe (3,932,160 k=31, w=1 probes on the 131,072 x
128 table) and its sorted form, and config 4's k=21 q8 index; with
``--deep DIR``, both forms on the deep world's q8 and q12 tables (16,384
reads, 2,129,920 probes). K4 cases (``std_plan``): K4 and its sorted form
on the wide std world of ``chip_smoke.py`` phase 7 (4,259,840 probes on
the 131,072 x 192 table, W = 32), K4 on the k=31 packed world (W = 16)
and, with ``--deep DIR``, K4 and its sorted form on the deep world's std
table (4,194,304 packed rows, W = 16; 8,519,680 probes). The worlds are
``ab_timing``'s; the deep index is built into DIR once.

Every plan of batch (the rows or probes whose key loads a group issues
together: K4 2 and 4; K2 takes 2 only), (warps a block, blocks an SM) of
SHAPES and L2 policy mode (0-2) is checked against the plain version, bit for bit, and timed by CUDA
events (``experiments.step_ms``: CALLS back-to-back launches, the median
of 10 samples; ``ms``) and by the profiler's device time a call
(``ab_timing.device_ms``; ``device_ms``, with K9's restore in a sorted
case), by which the plans are ranked: at the headline's 524,288 probes a
launch's host time exceeds K2's device time. Each plan is one JSON line;
the last line gives, for each case, the plan function's choice and its
times, and the fastest plans. It launches K2 and K4 past the wrappers, so
it counts no launches. A card is needed; it exits 1 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, NamedTuple

from . import _build
from .lookup import (QUOT_SPECS, STASH_ROWS, STASH_SMEM_MAX, STD_SPECS,
                     LookupPlan, _q8_kernel, _q12_kernel, _std_kernel,
                     bucket_sort, lookup_q8_plain, lookup_q12_plain,
                     lookup_std_plain, quot_plan, std_plan)

CALLS = 10
SHAPES = ((8, 2), (8, 3), (8, 4), (8, 8), (4, 8), (4, 16))  # (warps, an SM)
KERNELS = ("k2", "k4")


class Case(NamedTuple):
    name: str
    kernel: str                 # k2 or k4
    flat: tuple                 # the probes (hi, lo, valid), flat
    plain: Callable             # () -> the plain version's outputs
    run: Callable               # plan -> the kernel's outputs
    plans: Callable             # sms -> [(blocks an SM, plan)]
    chosen: Callable            # sms -> the plan function's choice


def _smem(stash_cols: int) -> int:
    smem = STASH_ROWS * 4 * stash_cols
    return smem if smem <= STASH_SMEM_MAX else 0


def plans(n: int, spec: int, batches, stash_cols: int, sms: int):
    """Every plan swept for n probes, with its blocks an SM."""
    for batch in batches:
        for warps, per_sm in SHAPES:
            grid = min(sms * per_sm, -(-n // (warps * 32)))
            for l2 in (0, 1, 2):
                yield per_sm, LookupPlan(grid, warps, batch, spec, l2,
                                         _smem(stash_cols))


def quot_plans(n: int, ways: int, stash_cols: int, q12: bool, sms: int):
    """K2's swept plans."""
    spec = ways if ways == QUOT_SPECS[q12] else 0
    return plans(n, spec, (2,), stash_cols, sms)


def std_plans(n: int, ways: int, stash_cols: int, sms: int):
    """K4's swept plans."""
    spec = ways if ways in STD_SPECS else 0
    return plans(n, spec, (2, 4), stash_cols, sms)


def k2_case(name: str, dev, flat, di, order) -> Case:
    """A K2 case: the probes ``flat`` of the q8 or q12 device index di."""
    q12 = di.cfg.layout == "q12"
    k, ways, n = di.cfg.k, di.cfg.ways, flat[0].numel()
    tab = (di.fused, di.stash)
    S = di.stash.shape[1]
    if q12:
        def plain():
            return lookup_q12_plain(*flat, *tab, k, ways)

        def run(plan):
            return _q12_kernel(dev, *flat, *tab, k, ways, order, plan=plan)
    else:
        def plain():
            return lookup_q8_plain(*flat, *tab, k)

        def run(plan):
            return _q8_kernel(dev, *flat, *tab, k, order, plan=plan)
    return Case(name, "k2", flat, plain, run,
                lambda sms: quot_plans(n, ways, S, q12, sms),
                lambda sms: quot_plan(n, ways, S, q12, order is not None,
                                      sms))


def k4_case(name: str, dev, flat, di, order) -> Case:
    """A K4 case: the probes ``flat`` of the std device index di."""
    tab = (di.fused, di.stash, di.cfg.ways)
    n, S = flat[0].numel(), di.stash.shape[1]
    return Case(name, "k4", flat, lambda: lookup_std_plain(*flat, *tab),
                lambda plan: _std_kernel(dev, *flat, *tab, order, None,
                                         plan=plan),
                lambda sms: std_plans(n, tab[2], S, sms),
                lambda sms: std_plan(n, tab[2], S, order is not None, sms))


def _with_sorted(make, name, dev, flat, di):
    """The case unsorted and sorted (given K9's order)."""
    yield make(name, dev, flat, di, None)
    k = None if di.cfg.layout == "std" else di.cfg.k
    yield make(f"{name}_sorted", dev, flat, di,
               bucket_sort(*flat, di.fused.shape[0], k))


def cases(torch, dev, deep: Path | None, kernels):
    from .ab_timing import (HEADLINE, PACKED, WIDE, bench_world, deep_index,
                            multik_world, probes)
    if "k2" in kernels:
        hdi, b1, b2 = bench_world(torch, dev, 16384, **HEADLINE)
        yield from _with_sorted(
            k2_case, "q8_headline", dev,
            probes(torch, b1, b2, HEADLINE["k"], HEADLINE["w"]), hdi)
        (di21, di31), c1, c2 = multik_world(torch, dev)
        yield from _with_sorted(k2_case, "c4_q12", dev,
                                probes(torch, c1, c2, 31, 1), di31)
        yield k2_case("c4_q8", dev, probes(torch, c1, c2, 21, 8), di21, None)
        if deep is not None:
            for layout in ("q8", "q12"):
                ddi, dflat = deep_index(torch, dev, deep, layout)
                yield from _with_sorted(k2_case, f"deep_{layout}", dev,
                                        dflat, ddi)
    if "k4" in kernels:
        di, b1, b2 = bench_world(torch, dev, 16384, **WIDE)
        yield from _with_sorted(k4_case, "wide", dev,
                                probes(torch, b1, b2, WIDE["k"], WIDE["w"]),
                                di)
        pdi, _, _ = bench_world(torch, dev, 1, **PACKED)
        yield k4_case("packed", dev,
                      probes(torch, b1, b2, PACKED["k"], PACKED["w"]), pdi,
                      None)
        if deep is not None:
            ddi, dflat = deep_index(torch, dev, deep, "std")
            yield from _with_sorted(k4_case, "deep", dev, dflat, ddi)


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--deep", type=Path, default=None,
                    help="also sweep the deep tables, their index in DIR")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help=f"the kernels to sweep, of {', '.join(KERNELS)}")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"kernels {kernels}: not all of {KERNELS}")
    if not torch.cuda.is_available():
        print("lookup_sweep: no CUDA device", file=sys.stderr)
        return 1
    from ..experiments import step_ms
    from .ab_timing import device_ms
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(0)
    summary = {"device": torch.cuda.get_device_name(dev), "cases": []}
    bad = 0
    for case in cases(torch, dev, args.deep, kernels):
        n = case.flat[0].numel()
        want = case.plain()
        lines = []
        for per_sm, plan in case.plans(sms):
            mism = sum(int((a != b).sum())
                       for a, b in zip(want, case.run(plan)))
            line = {"case": case.name, "kernel": case.kernel, "n": n,
                    **plan._asdict(), "blocks_per_sm": per_sm,
                    "ms": step_ms(lambda: case.run(plan), dev, CALLS),
                    "device_ms": device_ms(torch, lambda: case.run(plan)),
                    "mismatches": mism}
            bad += mism
            lines.append(line)
            print(json.dumps(line), flush=True)
        chosen = case.chosen(sms)
        summary["cases"].append({
            "case": case.name, "kernel": case.kernel, "n": n,
            "plan": chosen._asdict(),
            "plan_ms": step_ms(lambda: case.run(chosen), dev, CALLS),
            "plan_device_ms": device_ms(torch, lambda: case.run(chosen)),
            "fastest": [{k: b[k] for k in ("batch", "warps",
                                           "blocks_per_sm", "l2", "ms",
                                           "device_ms")}
                        for b in sorted(lines,
                                        key=lambda x: x["device_ms"])[:5]]})
    print(json.dumps(summary))
    if bad:
        print(f"lookup_sweep: {bad} mismatches", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
