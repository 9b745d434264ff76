#!/usr/bin/env python3
"""``trace_window.py`` on a multi-k cell, with the port's per-index totals
(``pangea_tpu_torch/trace.py`` ``index_steps``) of each of its windows.

    python3 benchmarks/trace_index_steps.py --workload <cell> --seed <n> \
        [--seconds 10]

from the root of a checkout, on a machine with a CUDA card. Each call of
``harness/drive.py`` ``run_window`` (the window with the tracer off, the
program-trace window, the profiler's window) is wrapped to take the
totals' difference over it. After ``trace_window.py``'s own JSON line,
standard output gets one more: ``windows``, a list in call order of
{"seconds", "events", "annotate", "index_steps": the totals over that
window, with ``host_ms`` and ``probes`` a call}, and ``index_steps``, the
process's totals (set-up's warm-up included)."""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import trace_window  # noqa: E402
from harness import drive, profile  # noqa: E402


def _delta(before: list, after: list) -> list:
    """Each index's totals over a window: after less before."""
    base = {r["index"]: r for r in before}
    out = []
    for rec in after:
        b = base.get(rec["index"], {})
        d = {k: rec[k] for k in ("index", "k", "w", "layout")}
        for k in ("calls", "probes", "sorted", "host_s"):
            d[k] = rec[k] - b.get(k, 0)
        if d["calls"]:
            d["host_ms"] = d["host_s"] / d["calls"] * 1e3
            d["probes_a_call"] = d["probes"] // d["calls"]
        out.append(d)
    return out


def main(argv=None) -> int:
    from pangea_tpu_torch import trace
    windows = []
    run_window = drive.run_window

    def wrapped(step, pool, packed_len, stride, seconds, *args, **kw):
        before = trace.index_steps()
        win = run_window(step, pool, packed_len, stride, seconds, *args,
                         **kw)
        windows.append({"seconds": seconds,
                        "events": kw.get("events", False),
                        "annotate": kw.get("annotate", False),
                        "index_steps": _delta(before, trace.index_steps())})
        return win

    drive.run_window = profile.run_window = wrapped
    try:
        rc = trace_window.main(argv)
    finally:
        drive.run_window = profile.run_window = run_window
    print(json.dumps({"windows": windows,
                      "index_steps": trace.index_steps()}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
