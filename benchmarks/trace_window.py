#!/usr/bin/env python3
"""The port's own tracing of one cell: its spans and launch records over
the benchmark's step, beside a window with the tracer off.

    python3 benchmarks/trace_window.py --workload <cell> --seed <n> \
        [--seconds 10]

from the root of a checkout, on a machine with a CUDA card (exits 2
without one). Set-up as a run of the cell (``harness/cell.py``), then, on
one step, pool and drain discipline (``harness/drive.py``):

- a window of ``--seconds`` with the tracer off and a CUDA event before
  and after each step, as a traced run's measured window;
- the program-trace window, PROGRAM_SECONDS with the tracer on (the port's
  ``trace.collect``), no profiler and no events of the harness's own;
- the profiler's window (``harness/profile.py``) with the tracer on, so
  that its idle gaps are named by the port's spans beside ``main.step``.

Standard error gets the program-trace window's step self times, its
longest in-step gaps with the span that held each, its launch records by
launcher beside ``kernel_launches()``'s deltas, the placement's record
and the profiler's breakdown. The last line of standard output is one
JSON object: the readings of the program-trace window (``launch_block_ms``,
``launch_gap_ms``, ``probe_ms``, ``step_ms``), the placement's
(``place_layout_s``, ``place_copy_s``, ``read_bytes``), each window's
``reads_per_s`` and ``enqueue_ms``, the off window's ``step_ms`` and
``device_idle_pct`` by events, and the profiler window's busy share.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(1, os.path.join(ROOT, "src"))

from harness import drive, sut  # noqa: E402
from harness.cell import Run  # noqa: E402

PROGRAM_SECONDS = 2.0


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


WINDOW_METRICS = ("reads_per_s", "enqueue_ms", "step_ms", "device_idle_pct")


def window_numbers(spec, win) -> dict:
    """The benchmark's readers of WINDOW_METRICS on a window (step_ms and
    device_idle_pct only where it recorded events)."""
    run = Run(win.t_close - win.t_open, 0.0, 0.0, win)
    out = {name: spec.reader(name)(run) for name in WINDOW_METRICS}
    return {k: v for k, v in out.items() if v is not None}


def program_window(step, pool, packed_len, stride,
                   seconds: float = PROGRAM_SECONDS):
    """The program-trace window: ``drive.run_window`` with the port's
    tracer on. Returns (the trace's summary, the window, the
    ``kernel_launches()`` deltas over it)."""
    from pangea_tpu_torch import trace
    before = sut.launches()
    with trace.collect() as program:
        win = drive.run_window(step, pool, packed_len, stride, seconds)
    after = sut.launches()
    return program.summary(), win, {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the port's launch records need the card")
        return 2
    from harness import worlds
    from harness.cell import _split, draw_inputs
    from harness.profile import profile_window
    from harness.spec import Spec
    from pangea_tpu_torch import trace

    spec = Spec(ROOT)
    cell = spec.cell(args.workload, True)
    cfg, tr = cell.config, cell.traffic
    device = torch.device("cuda:0")
    world = worlds.make_world(cfg["world"])
    cache = os.path.join(spec.bench_dir, "cache")
    paths = [sut.ensure_index(cache, cfg, cell.config_path, i, world, log)[0]
             for i in range(len(cfg["indexes"]))]
    t = time.perf_counter()
    step, placed = sut.open_step(paths, cfg, device)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t
    sut.check_geometry(placed, cfg)
    L, B = tr["max_read_len"], tr["batch"]
    stride = worlds.wire_width(L)
    pool_codes, _ = draw_inputs(world, tr, args.seed)
    pool = []
    for r1, r2 in pool_codes:
        rows = worlds.pack_wire(r1, L)
        if r2 is not None:
            rows = np.concatenate([rows, worlds.pack_wire(r2, L)], axis=1)
        pool.append((torch.from_numpy(rows).to(device), B))
    outs = [step(*_split(pool[i % len(pool)][0], stride), packed_len=L)
            for i in range(max(len(pool), drive.DRAIN_DEPTH + 2))]
    for o in outs:
        {k: o[k].cpu() for k in drive.OUT_KEYS}
    del outs
    torch.cuda.synchronize()

    off = drive.run_window(step, pool, L, stride, args.seconds, events=True)
    got, on, deltas = program_window(step, pool, L, stride)
    with trace.collect():
        prof = profile_window(step, pool, L, stride, sut.launches)

    placement = [p for p in trace.placements() if p["device"] == "cuda"]
    log("card: " + torch.cuda.get_device_name(device))
    log(f"placement: {place_s:.3f} s by the host clock; "
        + json.dumps(placement))
    log(f"program-trace window: {got['steps']} steps; step self ms "
        + json.dumps({k: round(v, 4) for k, v in got["self_ms"].items()}))
    log("longest in-step gaps (ms, span): "
        + json.dumps([[round(ms, 4), name] for ms, name in got["gaps"]]))
    log("launch records by launcher " + json.dumps(got["launches"])
        + "; kernel_launches() deltas " + json.dumps(deltas))
    log("profiler window, tracer on: launches "
        + json.dumps(prof.pop("launches")) + "; events "
        + json.dumps(prof.pop("events")) + "; breakdown "
        + json.dumps(prof["breakdown"]))
    result = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(device),
        "steps": got["steps"],
        **{k: got[k] for k in ("step_ms", "launch_block_ms",
                               "launch_gap_ms", "probe_ms")},
        "place_s": place_s,
        "place_layout_s": sum(p["place.layout"] for p in placement),
        "place_copy_s": sum(p["place.copy"] for p in placement),
        "read_bytes": [p["read_bytes"] for p in placement],
        "off": window_numbers(spec, off), "on": window_numbers(spec, on),
        "profile_busy_share": prof["busy_s"] / prof["window_s"],
        "launch_records": got["launches"],
        "gaps": got["gaps"], "self_ms": got["self_ms"],
        "breakdown": prof["breakdown"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
