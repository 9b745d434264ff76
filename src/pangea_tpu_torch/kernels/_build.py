"""Build and bind the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files compile with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded through ``ctypes``. The
library is built at first use into a per-user cache directory named by the
hash of the sources and flags, ``$XDG_CACHE_HOME/pangea_tpu_torch/<hash>/``
(``~/.cache`` without ``XDG_CACHE_HOME``), so builds from different sources
never replace one another. Nothing is built or loaded when this module is
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
LIB_NAME = "libpangea_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C signature of every exported launcher: (argtypes), all return cudaError_t.
# :func:`launch` passes the stream, the last argument, itself.
SIGNATURES = {
    # codes, B, L, k, w, hi, lo, valid, R, col0, stream
    "pangea_extract_probes": (_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P),
    # hi, lo, valid, N, fused, NB, W, stash, S, k, hit, t_in, t_out, stream
    "pangea_lookup_q8": (_P, _P, _P, _I64, _P, _I64, _I, _P, _I, _I,
                         _P, _P, _P, _P),
    # hit, t_in, t_out, valid, B, R, tin, tout, depth, T1, thr,
    # taxon, best, nvalid, stream
    "pangea_score_tin": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _F,
                         _P, _P, _P, _P),
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


def build_dir() -> Path:
    """Where the library of the current sources lives."""
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "pangea_tpu_torch" / _source_hash()


def build() -> Path:
    """Compile csrc/*.cu unless the library of the current sources exists.
    Returns the library's path."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
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


def launch(name: str, device, *args) -> None:
    """Call one launcher with ``device`` as the current CUDA device and its
    current stream as the last argument; raise if it reports a CUDA
    error."""
    import torch
    with torch.cuda.device(device):
        err = getattr(library(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def dispatch_device(*tensors):
    """None when every tensor lies on the CPU (the wrapper then runs the
    plain version); the common CUDA device otherwise. Raises for mixed
    devices and for any other device type."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    (dev,) = devs
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return dev


def check(t, dtype, *, shape=None, ndim=None, name: str = "tensor") -> None:
    """Raise unless t has the dtype (and shape or rank) a kernel takes and
    is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()} dims, want {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel takes contiguous tensors")
