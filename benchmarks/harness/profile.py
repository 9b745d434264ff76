"""The traced run's profiler window: ``torch.profiler`` over a window of
its own (PROFILE_SECONDS, after the measured one, the same discipline and
pool), read from its Chrome trace.

It gives ``device.busy_s`` (the union of the device's operations) and
``window_s`` (the window's host seconds), the ``breakdown`` (the device
operations with the most time, and the longest idle gaps named by the
host phases, ``main.step``, ``main.queue_put`` and ``drain.fetch``, that
spanned them) and each kernel's count of events beside the port's own
launch counts. It decides no metric: the profiler has dropped launches
on this card.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import Counter

from .drive import run_window

PROFILE_SECONDS = 2.0
TOP = 10
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_window(step, pool, packed_len, stride, launches):
    """Run the profiler window; returns a dict with busy_s, window_s,
    breakdown and counts (profiler events by kernel name, launches by the
    port's counters)."""
    from torch.profiler import ProfilerActivity, profile
    before = launches()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_window(step, pool, packed_len, stride, PROFILE_SECONDS,
                       annotate=True)
            window_s = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    finally:
        os.remove(path)
    after = launches()
    out = analyse(trace.get("traceEvents", []))
    out["window_s"] = window_s
    out["launches"] = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
    return out


def analyse(events: list) -> dict:
    """busy_s, the breakdown and the kernel event counts of a Chrome
    trace's events (µs timestamps)."""
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") in DEVICE_CATS)
    host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"])
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]
    by_name: Counter = Counter()
    counts: Counter = Counter()
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-6
        counts[name] += 1
    merged: list = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    gaps = sorted(((b - a, a, b) for (_, a), (b, _)
                   in zip(merged, merged[1:])), reverse=True)[:TOP]
    idle = []
    for width, a, b in gaps:
        mid = (a + b) / 2
        label = "+".join(sorted({n for s, t, n in host if s <= mid < t}))
        idle.append([label or "host.other", width * 1e-6])
    return {"busy_s": busy,
            "breakdown": {"device_ops": [[n, s] for n, s in
                                         by_name.most_common(TOP)],
                          "idle_gaps": idle},
            "events": dict(counts)}
