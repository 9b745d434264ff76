"""Time two ways of building the kernels of ``csrc/``, on a machine with
``nvcc``:

- serial: one ``nvcc`` over every source into one library;
- parallel: one ``nvcc`` a source, all started together, then one link
  (:func:`pangea_tpu_torch.kernels._build.compile_library`, what the
  package does).

Run from the repository root:

    PYTHONPATH=src python -m pangea_tpu_torch.kernels.time_build [--rounds N]

Each round builds serial, parallel, parallel, serial, each into a fresh
directory beside the package's build directory, and prints the wall
seconds of each build; the last line is a JSON object of the medians.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import time

from . import _build


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    nvcc = _build._nvcc()
    srcs = [str(s) for s in _build._sources() if s.suffix == ".cu"]
    work = _build.build_dir().parent / "time_build"
    designs = {
        "serial": lambda lib: _build.run_all([[
            nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), *srcs]]),
        "parallel": lambda lib: _build.compile_library(nvcc, lib)}
    secs = {name: [] for name in designs}
    for r in range(args.rounds):
        for i, name in enumerate(("serial", "parallel", "parallel",
                                  "serial")):
            out = work / f"{r}_{i}_{name}"
            shutil.rmtree(out, ignore_errors=True)
            out.mkdir(parents=True)
            t0 = time.perf_counter()
            designs[name](out / _build.LIB_NAME)
            secs[name].append(time.perf_counter() - t0)
            print(f"round {r}, {name}: {secs[name][-1]} s "
                  f"({len(srcs)} sources, {os.cpu_count()} CPUs)", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({name: {"median_s": statistics.median(v), "runs": v}
                      for name, v in secs.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
