"""Registers, spills and stack of each compiled kernel, as ``ptxas -v``
reports them, on a machine with ``nvcc``:

    PYTHONPATH=src python -m pangea_tpu_torch.kernels.ptxas_usage \\
        [--csrc DIR] [--sources score_tin.cu,score_ranked.cu] \\
        [--match score_kernel]

Each source of DIR (the package's ``csrc/`` by default; another
checkout's to compare two) compiles with the package's flags
(``_build.NVCC_FLAGS``) and ``-Xptxas -v`` into a scratch object; the
output is one JSON line: source -> kernel (demangled where ``c++filt``
is found) -> registers, spill store and load bytes, stack frame bytes.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from . import _build


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout
    return out.splitlines()


def usage(src: Path, nvcc: str, match: str) -> dict:
    """kernel -> its ptxas resource line's numbers, for one source."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
             str(Path(tmp) / "k.o"), str(src)],
            capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    found, name = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            found[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            found[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name]["registers"] = int(m.group(1))
    names = list(found)
    return {pretty: found[raw]
            for raw, pretty in zip(names, _demangle(names))
            if match in pretty}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--csrc", type=Path, default=_build.CSRC)
    p.add_argument("--sources", default="",
                   help="comma-separated .cu files of DIR (default: all)")
    p.add_argument("--match", default="",
                   help="keep the kernels whose name holds this")
    args = p.parse_args(argv)
    nvcc = _build._nvcc()
    srcs = (sorted(args.csrc.glob("*.cu")) if not args.sources else
            [args.csrc / name for name in args.sources.split(",")])
    print(json.dumps({src.name: usage(src, nvcc, args.match)
                      for src in srcs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
