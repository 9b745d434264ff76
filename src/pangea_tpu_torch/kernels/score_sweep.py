"""Sweep the scorer's table capacity on the card: where the distinct-
interval table stops beating the general branch.

    PYTHONPATH=src python -m pangea_tpu_torch.kernels.score_sweep

Cases (``bench.score_world``, intervals of unrelated taxa of the
66,563-taxon tree): K3's q8 form at the headline's 16,384 x 32 (no
misses), its taxon form at the std world's 16,384 x 260 and at a
1,180-probe bucket of 64 reads, and K8 at 75 x 16,364 (half of the
probes misses). At each U of US that a read's hits can hold, the winners
form runs with a table of SCORE_MAX_CAP entries (the table path) and with
one of 1 (every read with a hit takes the general branch), launched past
the wrapper (``score._launch_score`` with the plan), each held to
``score_winners_plain`` first and timed by the profiler's device time a
call over ``ab_timing.PROFILED`` calls. Each (case, U) is one JSON line;
the last line gives, for each case, the largest U at which the table is
faster. ``score.SCORE_CAPS`` is chosen from it. A card is needed; it exits
1 without one.
"""
from __future__ import annotations

import json
import sys

US = (1, 2, 4, 8, 16, 32, 48, 64, 96, 128)
# (name, reads, probes a read, taxon lanes, share of misses)
CASES = (("k3_q8_headline", 16384, 32, False, 0.0),
         ("k3_taxon_std", 16384, 260, True, 0.5),
         ("k3_bucket", 64, 1180, True, 0.5),
         ("k8", 75, 16364, True, 0.5))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("score_sweep: no CUDA device", file=sys.stderr)
        return 1
    from ..bench import score_world
    from ..utils import datagen
    from . import score_plan, score_winners_plain
    from .ab_timing import device_ms
    from .score import SCORE_MAX_CAP, _launch_score
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tax = datagen.make_taxonomy(2, 512, 64, seed=0)
    best = {}
    for name, B, R, taxon_lanes, miss in CASES:
        hits = R - round(miss * R)
        for U in US:
            if U > hits:
                continue
            world = score_world(tax, B, R, U, False, miss, seed=U)
            lanes, t_in, t_out, valid = (torch.from_numpy(a).to(dev)
                                         for a in world)
            if not taxon_lanes:
                lanes = (lanes != 0).to(torch.int32)
            args = (lanes, t_in, t_out, valid)
            want = score_winners_plain(*args, taxon_lanes)
            line = {"case": name, "B": B, "R": R, "U": U}
            for form, cap in (("table", SCORE_MAX_CAP), ("general", 1)):
                plan = score_plan(B, R, sms, cap)

                def run():
                    return _launch_score(dev, *args, taxon_lanes, plan=plan)
                mism = sum(int((a != b).sum()) for a, b in zip(want, run()))
                if mism:
                    raise AssertionError(f"{name} U={U} {form}: {mism} "
                                         "mismatches")
                line[f"{form}_device_ms"] = device_ms(torch, run)
            print(json.dumps(line), flush=True)
            if line["table_device_ms"] < line["general_device_ms"]:
                best[name] = U
    print(json.dumps({"table_faster_up_to_u": best}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
