"""Sweep K1's launch plans on the card, at the main paths' shapes.

    PYTHONPATH=src python -m pangea_tpu_torch.kernels.extract_sweep

Cases (``ab_timing``'s k1 worlds): the bench's 16,384 first mates of 150
bases at k=21, w=1 (the std world) and w=8 (the q8 headline), and a
long-read bucket of 75 reads of 16,384 bases at k=21, w=1 and w=8. Every
plan of (warps a block, warps an SM before a read is cut into tiles) of
SHAPES is checked against ``extract_probes_plain``, bit for bit, and
timed by the profiler's device time a call over ``ab_timing.PROFILED``
calls. Each plan is one JSON line; the last line gives, for each case,
``k1_plan``'s choice and its time, and the fastest plan. It launches K1
past the wrappers, so it counts no launches. A card is needed; it exits
1 without one.
"""
from __future__ import annotations

import json
import sys

SHAPES = tuple((warps, sm_warps) for warps in (2, 4, 8)
               for sm_warps in (8, 16, 32, 64))
CASES = (("w1_std", 21, 1, False), ("w8_headline", 21, 8, False),
         ("w1_bucket", 21, 1, True), ("w8_bucket", 21, 8, True))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("extract_sweep: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from . import _build, extract_probes_plain
    from .ab_timing import device_ms, k1_reads
    from .minimize import (K1_SM_WARPS, K1_WARPS, _launch_k1, k1_plan,
                           probe_width)
    dev = torch.device("cuda", 0)
    sms = _build.sm_count(0)
    mates, long = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in k1_reads())
    best = {}
    for name, k, w, bucket in CASES:
        codes = long if bucket else mates
        B, L = codes.shape
        nw = probe_width(L, k, w)
        want = [torch.empty((B, nw), dtype=t, device=dev)
                for t in (torch.int32, torch.int32, torch.bool)]
        extract_probes_plain(codes, k, w, want, 0)
        times = {}
        for warps, sm_warps in SHAPES:
            plan = k1_plan(B, L, k, w, sms, warps, sm_warps)
            out = [torch.empty_like(t) for t in want]

            def run():
                _launch_k1(dev, codes, L, L, False, k, w, out, 0, plan)
            run()
            mism = sum(int((a != b).sum()) for a, b in zip(want, out))
            if mism:
                raise AssertionError(f"{name} {plan}: {mism} mismatches")
            ms = device_ms(torch, run)
            times[(warps, sm_warps)] = ms
            print(json.dumps({"case": name, "warps": warps,
                              "sm_warps": sm_warps, "plan": plan._asdict(),
                              "device_ms": ms}), flush=True)
        fastest = min(times, key=times.get)
        best[name] = {"k1_plan": k1_plan(B, L, k, w, sms)._asdict(),
                      "k1_plan_ms": times[(K1_WARPS, K1_SM_WARPS)],
                      "fastest": {"warps": fastest[0],
                                  "sm_warps": fastest[1],
                                  "device_ms": times[fastest]}}
    print(json.dumps({"best": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
