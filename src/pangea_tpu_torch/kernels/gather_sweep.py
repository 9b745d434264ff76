"""Sweep K13's launch plans on the card, at the experiments' shapes.

    PYTHONPATH=src python -m pangea_tpu_torch.kernels.gather_sweep

On ``experiments.mb_gather``'s world (a [2^19, 64] uint32 table, 256-B
rows), for the staged form on 2^20 and 2^19 indices and the direct form on
2^19, every plan of slots a lane (1, 2, 4), issuing lanes a warp (16, 32),
warps a block (1, 2, 4, 8) and blocks an SM (1, 2, 4 and as many as the
shared memory holds) is checked against ``row_gather_plain`` and timed
(``experiments.step_ms``: CUDA events over CALLS back-to-back launches,
the median of 10 samples) beside ``torch.index_select`` on the same
indices. Each plan is one JSON line (``rows_per_sm``: ring slots an SM;
``lanes_per_sm``: issuing lanes an SM); the last line gives, for each case, ``gather_plan``'s choice and
the fastest plans. It launches K13 directly, past the wrappers, so it
counts no launches. A card is needed; it exits 1 without one.
"""
from __future__ import annotations

import json
import sys

from . import _build
from .gather import (BARRIER_BYTES, SM_BLOCKS, SM_RESERVED, SM_THREADS,
                     SMEM_OPTIN, gather_plan, row_gather_plain)

CHUNK = 4096
CALLS = 10
CASES = ((1 << 20, False), (1 << 19, False), (1 << 19, True))


def plans(sms: int, slot_bytes: int):
    """(grid, warps, lanes, slots, blocks an SM) of every plan swept."""
    for per_lane in (1, 2, 4):
        for lanes in (32, 16):
            for warps in (1, 2, 4, 8):
                slots = lanes * per_lane
                smem = warps * slots * (slot_bytes + BARRIER_BYTES)
                if smem > SMEM_OPTIN:
                    continue
                most = min((SMEM_OPTIN + SM_RESERVED) // (smem + SM_RESERVED),
                           SM_THREADS // (32 * warps), SM_BLOCKS)
                for per_sm in sorted({1, 2, 4, most}):
                    if per_sm <= most:
                        yield sms * per_sm, warps, lanes, slots, per_sm


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("gather_sweep: no CUDA device", file=sys.stderr)
        return 1
    from ..experiments import mb_gather as MG
    from ..experiments import step_ms
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    table, idx = MG.world_tensors(MG.make_world(0), dev)
    row_bytes = table.shape[1] * table.element_size()
    summary = {"device": torch.cuda.get_device_name(dev), "cases": []}
    for n, direct in CASES:
        ix = idx[:n]
        want = row_gather_plain(table, ix)
        out = torch.empty_like(want)

        def launch(grid, warps, lanes, slots):
            _build.launch("pangea_row_gather", dev, table.data_ptr(),
                          table.shape[0], row_bytes, 1, ix.data_ptr(), n,
                          CHUNK, int(direct), grid, warps, lanes, slots,
                          out.data_ptr())
        library_ms = step_ms(lambda: torch.index_select(table, 0, ix), dev,
                             CALLS)
        lines = []
        for grid, warps, lanes, slots, per_sm in plans(sms, row_bytes):
            out.zero_()
            launch(grid, warps, lanes, slots)
            mism = int((out != want).sum())
            ms = step_ms(lambda: launch(grid, warps, lanes, slots), dev,
                         CALLS)
            line = {"n": n, "direct": direct, "slots_per_lane":
                    slots // lanes, "lanes": lanes, "warps": warps,
                    "blocks_per_sm": per_sm, "rows_per_sm": per_sm * warps
                    * slots, "lanes_per_sm": per_sm * warps * lanes,
                    "ms": ms, "library_ms": library_ms, "mismatches": mism}
            lines.append(line)
            print(json.dumps(line), flush=True)
        if any(line["mismatches"] for line in lines):
            print(f"gather_sweep: mismatches at n={n}, direct={direct}",
                  file=sys.stderr)
            return 1
        best = sorted(lines, key=lambda line: line["ms"])[:3]
        summary["cases"].append({
            "n": n, "direct": direct, "library_ms": library_ms,
            "plan": gather_plan(n, 16, CHUNK, row_bytes, sms,
                                SMEM_OPTIN)._asdict(),
            "fastest": [{k: b[k] for k in ("slots_per_lane", "lanes",
                                           "warps", "blocks_per_sm", "ms")}
                        for b in best]})
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
