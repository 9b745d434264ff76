#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name (``BENCHMARK.json``, ``benchmarks/
configs``, ``traffic`` and ``metrics``). The last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, ``build_s`` (the seconds a
checkout's first run spends building the index, left out of ``setup_s``),
and last ``limits``, each number the check compared with its limit; the
same numbers end standard error. Exits 2 without a CUDA card (or with fewer than the cell asks for)
and 3 if JAX or the JAX package was loaded, printing no result.
"""
import time

T0 = time.perf_counter()


def _age() -> float:
    """Seconds since this process began (the kernel's start time), or 0
    where /proc cannot tell."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        import os
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = _age()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "pangea_tpu")
# Caches of the program and its libraries, at fixed places in the
# checkout (the port builds its kernels under build/kernels/ itself).
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(HERE, "cache",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(HERE, "cache", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(1, os.path.join(ROOT, "src"))


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def started() -> float:
    return AGE0 + time.perf_counter() - T0


def forbidden_modules() -> list:
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.spec import Spec
    spec = Spec(ROOT)
    cell = spec.cell(args.workload, bool(args.trace))
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
            f"{cell.chips}")
        return 2
    from harness.cell import run_cell
    result = run_cell(spec, cell, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", started, log)
    loaded = forbidden_modules()
    if loaded:
        log(f"loaded in this process: {', '.join(loaded)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
