"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``, all
started together, and one link joins the objects into a shared library
with a plain C interface, loaded through ``ctypes``. The library is built
at first use into a directory named by the hash of the sources and flags,
so builds from different sources never replace one another:
``build/kernels/<hash>/`` of the repository when the package runs from a
checkout (``build/`` is ignored by git), else
``$XDG_CACHE_HOME/pangea_tpu_torch/<hash>/`` (``~/.cache`` without
``XDG_CACHE_HOME``). Nothing is built or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from .. import trace

CSRC = Path(__file__).resolve().parent.parent / "csrc"
LIB_NAME = "libpangea_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# The scorers' launchers (K3, K8), see SIGNATURES.
_SCORE = (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _I, _F,
          _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
          _I, _I, _I, _I, _I, _P, _P)
# C signature of every exported launcher: (argtypes), all return cudaError_t.
# :func:`launch` passes the stream, the last argument, itself.
SIGNATURES = {
    # codes, B, L, k, w, hi, lo, valid, R, col0, packed, pitch, grid,
    # warps, tiles, tile_windows (minimize.k1_plan), stream
    "pangea_extract_probes": (_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                              _I64, _I, _I, _I, _I, _P),
    # hi, lo, valid, N, NB, k (0: the std bucket), key shift, counts, order,
    # inv, stream
    "pangea_bucket_sort": (_P, _P, _P, _I64, _I64, _I, _I, _P, _P, _P, _P),
    # inv, sorted_out, N, o0, o1, o2, stream
    "pangea_bucket_restore": (_P, _P, _I64, _P, _P, _P, _P),
    # The lookups take K9's order and a sorted_out (both NULL: unsorted)
    # before their outputs.
    # hi, lo, valid, N, fused, NB, W, stash, S, k, order, sorted_out, hit,
    # t_in, t_out, grid, warps, batch, spec, l2, smem (lookup.quot_plan),
    # stream
    "pangea_lookup_q8": (_P, _P, _P, _I64, _P, _I64, _I, _P, _I, _I,
                         _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # hi, lo, valid, N, fused, NB, W, row_lanes, stash, S, k, order,
    # sorted_out, hit, t_in, t_out, grid, warps, batch, spec, l2, smem
    # (lookup.quot_plan), stream
    "pangea_lookup_q12": (_P, _P, _P, _I64, _P, _I64, _I, _I, _P, _I, _I,
                          _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # hi, lo, valid, N, fused, NB, W, packed, stash, S, owner_shift,
    # shard_id, order, sorted_out, taxon, t_in, t_out, grid, warps, batch,
    # spec, l2, smem (lookup.std_plan), stream
    "pangea_lookup_std": (_P, _P, _P, _I64, _P, _I64, _I, _I, _P, _I, _I,
                          _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P),
    # hi, lo, valid, N, log2 S, C, counts, records, inv, stream
    "pangea_route_bin": (_P, _P, _P, _I64, _I, _I, _P, _P, _P, _P),
    # lanes, t_in, t_out, valid, B, R, taxon_lanes, tin, tout, depth, T1,
    # parent, up, levels, tin2node, M, thr, o0..o5, general, prior taxon,
    # best, nvalid, the merge's parent, depth, up, levels, T1, wpr, rpb,
    # cap, per_read, rpad, scratch (score.score_plan), stream: K3 and K8
    # take the same arguments
    "pangea_score": _SCORE,
    "pangea_score_ranked": _SCORE,
    # b, rem, N, NB, shift, counts, records, stream: the row probes'
    # routing pass (rowprobe.rowprobe_plan, route_scratch)
    "pangea_rowprobe_route": (_P, _P, _I64, _I64, _I, _P, _P, _P),
    # table, NB, W, shift, window_keys, records, N, out, stream: K11 and
    # K12 on the routing pass's records (rowprobe.rowprobe_plan)
    "pangea_rowprobe_smem": (_P, _I64, _I, _I, _I, _P, _I64, _P, _P),
    "pangea_rowprobe_onehot": (_P, _I64, _I, _I, _I, _P, _I64, _P, _P),
    # table, NB, row_bytes, rows, idx, n, chunk, direct, grid, warps,
    # lanes, slots (gather.gather_plan), out, stream
    "pangea_row_gather": (_P, _I64, _I, _I, _P, _I64, _I, _I, _I, _I, _I,
                          _I, _P, _P),
    # table, NB, row_bytes, rows, start, out, stream: K13 on one index
    "pangea_block_copy": (_P, _I64, _I, _I, _P, _P, _P),
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _checkout_root() -> Path | None:
    """The repository root when the sources lie in its
    ``src/pangea_tpu_torch/csrc``, else None (an installed package)."""
    root = CSRC.parent.parent.parent
    if CSRC.parent.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root
    return None


def user_cache() -> Path:
    """The package's directory in the user's cache."""
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "pangea_tpu_torch"


def build_dir() -> Path:
    """Where the library of the current sources lives."""
    root = _checkout_root()
    base = root / "build" / "kernels" if root is not None else user_cache()
    return base / _source_hash()


def run_all(cmds: list[list[str]]) -> None:
    """Run the commands all at once; raise with the output of each that
    fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    errors = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}{stderr}")
    if errors:
        raise RuntimeError("\n".join(errors))


def compile_library(nvcc: str, lib: Path) -> None:
    """Compile csrc/*.cu into the shared library ``lib``: one nvcc a
    source, all started together, then one link."""
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    objs = [lib.parent / f"{p.stem}.{os.getpid()}.o" for p in srcs]
    try:
        run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
                 for p, o in zip(srcs, objs)])
        run_all([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]])
    finally:
        for o in objs:
            o.unlink(missing_ok=True)


def build() -> Path:
    """Compile csrc/*.cu unless the library of the current sources exists.
    Returns the library's path."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    compile_library(nvcc, tmp)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with argtypes set for every launcher."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


# Each launcher's ctypes function, looked up once (launcher()).
_launchers: dict = {}


def launcher(name: str):
    """The ctypes function of launcher ``name``."""
    fn = _launchers.get(name)
    if fn is None:
        fn = _launchers[name] = getattr(library(), name)
    return fn


def launch(name: str, device, *args) -> None:
    """Call one launcher with ``device`` as the current CUDA device and the
    handle of its current stream as the last argument; raise if it reports
    a CUDA error. The device is made current, and put back after, only
    where another one is. While a trace is collected the call is a launch
    record (``trace.recorded``)."""
    fn = _launchers.get(name) or launcher(name)
    if trace.ON:
        fn = trace.recorded(name, fn)
    index = device.index
    if torch._C._cuda_getDevice() == index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def dispatch_device(*tensors):
    """None when every tensor lies on the CPU (the wrapper then runs the
    plain version); the common CUDA device otherwise. Raises for mixed
    devices and for any other device type."""
    first = tensors[0]
    dev = first.device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on several devices: "
                             f"{sorted({str(t.device) for t in tensors})}")
    if first.is_cuda:
        return dev
    if first.is_cpu:
        return None
    raise ValueError(f"no kernel for device {dev}")


def check(t, dtype, *, shape=None, ndim=None, name: str = "tensor") -> None:
    """Raise unless t has the dtype (and shape or rank) a kernel takes and
    is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, want {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")
