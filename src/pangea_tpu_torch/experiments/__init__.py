"""The port's counterparts of the repository's Pallas experiments.

``python -m pangea_tpu_torch.experiments.mb_pallas`` runs the row probe of
``experiments/mb_pallas.py`` (K11 for ``take_lookup``, K12 for
``oneh_lookup``); ``python -m pangea_tpu_torch.experiments.mb_gather`` runs
the Pallas row gathers of ``experiments/mb_gather2.py``-``5.py`` as named
variants (K13). Each prints one JSON line a variant and, last, the process's
kernel launches. They run on the card (``--device cuda``, the default, which
exits non-zero without one: ``utils.device_from``, as ``cli classify``) or,
with ``--device cpu``, the plain versions.
Nothing runs when a module is imported.
"""
from __future__ import annotations

import json
import statistics
import time

WARMUP, REPS = 3, 10


def step_ms(fn, device, calls: int = 1) -> float:
    """Median ms of one call of fn over REPS samples of ``calls``
    back-to-back calls after WARMUP: CUDA events on a card, the host clock
    on the CPU."""
    import torch
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


def device_name(device) -> str:
    import torch
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)
