"""One run of one cell: set-up, the measured window, the traced
profiler window (``--trace 1``), the check, and the result line."""
from __future__ import annotations

import gc
import json
import os
import subprocess
import time
from dataclasses import dataclass

import numpy as np

from . import check, drive, roofline, sut, worlds


@dataclass
class Run:
    """What the metric readers (``metrics/<name>.py``) read: the window's
    length, the set-up and placement seconds, the window's batches, the
    roofline's least step ms (traced runs on a card in PEAKS) and the
    profiler window's reading (traced runs on a card)."""
    seconds: float
    setup_s: float
    place_s: float
    window: drive.Window
    least_ms: float | None = None
    profile: dict | None = None


def run_cell(spec, cell, seed: int, seconds: float, trace: bool, device,
             started, log, step_filter=None) -> dict:
    """Run ``cell`` once on ``device``. ``started()`` gives the seconds
    since the process began; ``log`` prints a line on standard error;
    ``step_filter(step)`` may stand another step in (the harness's own
    tests). Returns the result's object."""
    import torch
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    world = worlds.make_world(cfg["world"])
    cache = os.path.join(spec.bench_dir, "cache")
    paths, build_s = [], 0.0
    for i in range(len(cfg["indexes"])):
        path, dt = sut.ensure_index(cache, cfg, cell.config_path, i, world,
                                    log)
        paths.append(path)
        build_s += dt
    t = time.perf_counter()
    step, placed = sut.open_step(paths, cfg, device)
    if on_card:
        torch.cuda.synchronize()
    place_s = time.perf_counter() - t
    sut.check_geometry(placed, cfg)
    if step_filter is not None:
        step = step_filter(step)

    L, B = tr["max_read_len"], tr["batch"]
    stride = worlds.wire_width(L)
    pool_codes, sampler = draw_inputs(world, tr, seed)
    pool = []
    for r1, r2 in pool_codes:
        rows = worlds.pack_wire(r1, L)
        if r2 is not None:
            rows = np.concatenate([rows, worlds.pack_wire(r2, L)], axis=1)
        pool.append((torch.from_numpy(rows).to(device), B))
    # Warm-up: every pool batch once and the drain's depth in flight,
    # then every output back. On the card each step has to launch the
    # kernels the cell names.
    before = sut.launches() if on_card else {}
    n_warm = max(len(pool), drive.DRAIN_DEPTH + 2)
    outs = [step(*_split(pool[i % len(pool)][0], stride), packed_len=L)
            for i in range(n_warm)]
    for o in outs:
        {k: o[k].cpu() for k in drive.OUT_KEYS}
    del outs
    if on_card:
        sut.check_launches(cell.launches, before, sut.launches(), n_warm)
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    events = trace and on_card
    win = drive.run_window(step, pool, L, stride, seconds, events=events,
                           watch=sampler.watch)
    # The index build is the database's, made once a checkout (a lab
    # builds it once and classifies many samples against it): it is
    # reported as build_s, apart from the set-up.
    setup_s = started() - (time.perf_counter() - win.t_open) - build_s
    prof = None
    if trace and on_card:
        prof = _profile(step, pool, L, stride, log)
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del step, placed, pool
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        log(f"card: {_card()}")
    log(f"set-up {setup_s:.3f} s (placement {place_s:.3f} s), index build "
        f"{build_s:.3f} s apart; {len(win.batches)} batches in the window")

    run = Run(seconds, setup_s, place_s, win, profile=prof)
    if trace:
        run.least_ms = _least_ms(win, pool_codes, cfg, tr, world, kind, log)
    drained = sum(b.t_done is not None for b in win.batches)
    numbers, ref_s = check.judge(world, cfg, pool_codes, sampler,
                                 len(win.batches), drained,
                                 cache=os.path.join(cache, "reference"))
    log(f"reference: {ref_s:.3f} s")
    metrics = {}
    for m in cell.metrics:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type, "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": check.passes(numbers),
              "attempted": sum(b.n_reads for b in win.batches),
              "failed": sum(b.n_reads for b in win.batches
                            if b.t_done is None),
              "metrics": metrics, "device": dev}
    if prof is not None:
        dev["busy_s"] = prof["busy_s"]
        dev["window_s"] = prof["window_s"]
        result["breakdown"] = prof["breakdown"]
    result["build_s"] = build_s
    for line in check.describe(numbers):
        log(line)
    result["limits"] = numbers
    return result


def draw_inputs(world, tr: dict, seed: int):
    """The seed's read pool, ``tr["pool"]`` batches of ``tr["batch"]``
    reads as (codes, mate codes or None), and the check's sample of
    them."""
    reads_seq, check_seq = np.random.SeedSequence(seed).spawn(2)
    rng = np.random.default_rng(reads_seq)
    pool_codes = [worlds.sample_reads(world.genomes, tr["batch"], tr,
                                      rng)[:2] for _ in range(tr["pool"])]
    sampler = check.Sampler([tr["batch"]] * tr["pool"], tr["check_reads"],
                            np.random.default_rng(check_seq))
    return pool_codes, sampler


def _split(rows, stride: int):
    return rows[:, :stride], (rows[:, stride:] if rows.shape[1] > stride
                              else None)


def _profile(step, pool, L, stride, log) -> dict:
    from .profile import profile_window
    prof = profile_window(step, pool, L, stride, sut.launches)
    log("kernels: launches " + json.dumps(prof.pop("launches"))
        + "; profiler events " + json.dumps(prof.pop("events")))
    return prof


def _least_ms(win, pool_codes, cfg, tr, world, kind, log):
    """The mean least step ms over the window's batches, each pool batch
    counted by its launches."""
    row_words = worlds.wire_width(tr["max_read_len"]) * (
        2 if tr["paired"] else 1)
    specs = cfg["indexes"]
    per = []
    for r1, r2 in pool_codes:
        nbytes, ops = roofline.step_cost(r1, r2, row_words,
                                         len(world.parent) - 1, specs)
        least = roofline.least_ms(nbytes, ops, kind)
        if least is None:
            return None
        per.append(least[0])
        log(f"roofline: {nbytes} B, {ops} operations, least "
            f"{least[0]:.6f} ms by {least[1]}")
    slots = [b.slot for b in win.batches]
    return float(np.mean([per[s] for s in slots])) if slots else None


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
