#!/usr/bin/env python3
"""The control of the check that decides ``correct``.

    python benchmarks/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it draws the cell's read pool and the check's sample as a
run does, at the cell's own sizes, and puts the reference with a 16-bit
key fingerprint (``reference/control.py``) in the program's place: its
answers are judged against the exact reference as a run's are. Each line
gives the numbers beside their limits; the check works when every seed
reads ``correct`` false. The benchmark's runs never run this.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

from harness import check, worlds  # noqa: E402
from harness.cell import draw_inputs  # noqa: E402
from harness.spec import Spec  # noqa: E402
from reference import FingerprintMap, classify_reads  # noqa: E402


def control_run(spec: Spec, workload: str, seeds: list) -> list:
    """One result a seed: {"seed", "correct", "limits", "seconds"}."""
    cell = spec.cell(workload, False)
    cfg, tr = cell.config, cell.traffic
    world = worlds.make_world(cfg["world"])
    refs = check.reference_maps(world, cfg, os.path.join(
        spec.bench_dir, "cache", "reference"))
    tree, maps, specs = refs
    control = [FingerprintMap(m) for m in maps]
    out = []
    for seed in seeds:
        t = time.perf_counter()
        pool_codes, sampler = draw_inputs(world, tr, seed)
        slots = list(range(len(pool_codes)))
        got = np.stack(classify_reads(
            control, *check.sampled_reads(pool_codes, sampler, slots), tree,
            specs))
        at = 0
        for s in slots:
            m = sampler.idx[s].size
            sampler.variants[s] = [[got[:, at:at + m], 1]]
            at += m
        numbers, _ = check.judge(world, cfg, pool_codes, sampler,
                                 len(slots), len(slots), refs)
        out.append({"seed": seed, "correct": check.passes(numbers),
                    "limits": numbers,
                    "seconds": time.perf_counter() - t})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for r in control_run(Spec(ROOT), args.workload, args.seeds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
