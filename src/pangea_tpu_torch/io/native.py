"""ctypes bindings of the native reader and writer of the CLI.

The port's copy of ``pangea_tpu/io/native.py``: :class:`NativeFastxReader`
(FASTA/FASTQ, plain or gzipped, into packed wire rows for the fast path,
or into padded int8 codes for :func:`read_batches_native`, with the phred
qualities when asked), and :func:`write_assignments_native` (SEMANTICS.md
§10.1 lines from the step's outputs and the reader's id buffer). The
library is the port's own source, ``csrc/host/pangea_io.cpp``, built
with ``g++ ... -lz`` at first use into ``build/native/<hash>/`` of the
checkout (``$XDG_CACHE_HOME/pangea_tpu_torch/native/<hash>/`` outside
one), named by the hash of the source and flags. If it cannot be built,
the first use raises with the compiler's message: there is no fallback to
the Python reader. ``PANGEA_IO_LIB`` names a library to load in its place
(as the reference reads it): then nothing is built, and a missing or
unloadable file raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..kernels import _build
from ..taxonomy import RANK_NAMES

SOURCE = _build.CSRC / "host" / "pangea_io.cpp"
LIB_NAME = "libpangea_io.so"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
ID_STRIDE = 256          # bytes a read id in the reader's id buffer

_P = ctypes.c_void_p
_L = ctypes.c_long
_SIGNATURES = {
    "pangea_fastx_open": (_P, [ctypes.c_char_p]),
    "pangea_fastx_close": (None, [_P]),
    "pangea_fastx_error": (ctypes.c_char_p, [_P]),
    # h, max_reads, max_len, codes, lens, quals, ids, id_stride
    "pangea_fastx_next_batch": (_L, [_P, _L, _L, _P, _P, _P, _P, _L]),
    # h, max_reads, max_len, rows, lens, ids, id_stride, quals
    "pangea_fastx_next_batch_packed": (_L, [_P, _L, _L, _P, _P, _P, _L, _P]),
    # path, append, n, ids, id_stride, strip_mate_suffix, taxon, best,
    # nvalid, rank_code, names_blob, name_off, rank_blob, rank_off, do_fsync
    "pangea_write_assignments": (_L, [ctypes.c_char_p, ctypes.c_int, _L, _P,
                                      _L, ctypes.c_int, _P, _P, _P, _P, _P,
                                      _P, _P, _P, ctypes.c_int]),
}


def build_dir() -> Path:
    """Where the library of the current source lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    root = _build._checkout_root()
    base = (root / "build" if root is not None else _build.user_cache())
    return base / "native" / h.hexdigest()[:16]


def build() -> Path:
    """Compile the reader and writer unless the library of the current
    source exists; raise with the compiler's output if it fails."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    out.mkdir(parents=True, exist_ok=True)
    tmp = out / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE), "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native reader failed "
                           f"({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The native library, with its C signatures set: the file
    ``PANGEA_IO_LIB`` names, else the one :func:`build` makes."""
    path = os.environ.get("PANGEA_IO_LIB")
    if path:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"PANGEA_IO_LIB={path}: no such file")
        try:
            lib = ctypes.CDLL(os.path.abspath(path))
        except OSError as e:
            raise OSError(f"PANGEA_IO_LIB={path}: cannot load it: {e}") \
                from e
    else:
        lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


class NativeFastxReader:
    """Batched native reader of one FASTA/FASTQ file (plain or gzipped);
    with want_quals, each batch also carries the phred qualities (uint8
    [B, L], 0 past a read and for FASTA)."""

    def __init__(self, path: str, batch_size: int, max_len: int,
                 want_quals: bool = False):
        self._lib = library()
        self._h = self._lib.pangea_fastx_open(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self.path = path
        self.batch_size = batch_size
        self.max_len = max_len
        self.want_quals = want_quals

    def close(self) -> None:
        if self._h:
            self._lib.pangea_fastx_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def _batch(self, packed: bool):
        B, L = self.batch_size, self.max_len
        rows = (np.empty((B, (L + 15) // 16 + (L + 31) // 32), np.uint32)
                if packed else np.empty((B, L), np.int8))
        lens = np.empty(B, np.int32)
        quals = np.empty((B, L), np.uint8) if self.want_quals else None
        ids = ctypes.create_string_buffer(B * ID_STRIDE)
        qp = quals.ctypes.data if quals is not None else None
        if packed:
            n = self._lib.pangea_fastx_next_batch_packed(
                self._h, B, L, rows.ctypes.data, lens.ctypes.data, ids,
                ID_STRIDE, qp)
        else:
            n = self._lib.pangea_fastx_next_batch(
                self._h, B, L, rows.ctypes.data, lens.ctypes.data, qp, ids,
                ID_STRIDE)
        if n < 0:
            err = self._lib.pangea_fastx_error(self._h).decode()
            raise ValueError(f"{self.path}: {err}")
        if n == 0:
            return None
        return n, ids.raw, rows, lens, quals

    def next_batch_raw(self):
        """(n, ids_raw bytes [B * ID_STRIDE], codes int8 [B, L] padded with
        4, lens int32 [B], quals uint8 [B, L] or None) of the next up to B
        records, or None at the end. Rows past n are undefined; lens are the
        true lengths (a read longer than max_len keeps its first max_len
        bases). Raises ValueError on malformed input."""
        return self._batch(packed=False)

    def next_batch_packed(self):
        """(n, ids_raw, rows uint32 [B, wire width], lens, quals or None)
        as :meth:`next_batch_raw`, with each read packed into its wire row
        (``kernels.encode.wire_width``); the qualities stay on the host."""
        return self._batch(packed=True)

    def next_batch(self):
        """(ids list[str], codes int8 [n, L], lens int32 [n], quals uint8
        [n, L] or None) of the next batch, or None at the end."""
        b = self.next_batch_raw()
        if b is None:
            return None
        n, raw, codes, lens, quals = b
        ids = [raw[i * ID_STRIDE:(i + 1) * ID_STRIDE].split(b"\0", 1)[0]
               .decode() for i in range(n)]
        return (ids, codes[:n], lens[:n],
                quals[:n] if quals is not None else None)


class TaxBlobs:
    """A taxonomy's names and rank names as offset blobs for
    :func:`write_assignments_native`."""

    def __init__(self, taxonomy):
        def blob(strings):
            enc = [s.encode() for s in strings]
            off = np.zeros(len(enc) + 1, np.int64)
            np.cumsum([len(e) for e in enc], out=off[1:])
            return b"".join(enc), off

        self.names_blob, self.name_off = blob(taxonomy.names)
        self.rank_blob, self.rank_off = blob(RANK_NAMES)
        self.rank_code = np.ascontiguousarray(taxonomy.rank, dtype=np.int8)


def write_assignments_native(path: str, append: bool, ids_raw: bytes,
                             n: int, taxon, best, nvalid, blobs: TaxBlobs,
                             strip_mate_suffix: bool = True,
                             do_fsync: bool = False) -> int:
    """Write n assignment lines (byte-identical to
    ``report.writers.format_assignment``) from the step's outputs and the
    reader's id buffer (ID_STRIDE bytes an id; a trailing /1 or /2 dropped
    when strip_mate_suffix), with the taxonomy's :class:`TaxBlobs`;
    returns the file's size after the write, durable when do_fsync."""
    taxon, best, nvalid = (np.ascontiguousarray(a, dtype=np.int32)
                           for a in (taxon, best, nvalid))
    off = library().pangea_write_assignments(
        path.encode(), int(append), n, ids_raw, ID_STRIDE,
        int(strip_mate_suffix), taxon.ctypes.data, best.ctypes.data,
        nvalid.ctypes.data, blobs.rank_code.ctypes.data, blobs.names_blob,
        blobs.name_off.ctypes.data, blobs.rank_blob,
        blobs.rank_off.ctypes.data, int(do_fsync))
    if off < 0:
        raise OSError(f"native assignment write failed: {path}")
    return int(off)


def read_batches_native(path: str, batch_size: int, max_len: int,
                        mate_path: str | None = None,
                        sample: str | None = None):
    """``io.fastx.read_batches`` through the native reader: ReadBatches of
    up to batch_size reads (pairs), with the qualities of FASTQ input.
    Each read keeps at most max_len bases (the reader stores no more), and
    a trailing /1 or /2 leaves its id."""
    from .fastx import ReadBatch, sniff_format

    def reader(p):
        return NativeFastxReader(p, batch_size, max_len,
                                 want_quals=sniff_format(p) == "fastq")

    r1 = reader(path)
    r2 = reader(mate_path) if mate_path else None
    try:
        while True:
            b1 = r1.next_batch()
            if b1 is None:
                if r2 is not None and r2.next_batch() is not None:
                    raise ValueError(
                        f"{mate_path}: more records than {path}")
                return
            ids, codes, lens, quals = b1
            if r2 is not None:
                b2 = r2.next_batch()
                if b2 is None or len(b2[0]) != len(ids):
                    raise ValueError(
                        f"{mate_path}: fewer records than {path}")
                _, mcodes, mlens, mquals = b2
            ids = [i[:-2] if i.endswith(("/1", "/2")) else i for i in ids]
            n = len(ids)
            yield ReadBatch(
                ids=ids,
                seqs=[codes[i, :lens[i]].view(np.uint8) for i in range(n)],
                quals=([quals[i, :lens[i]] for i in range(n)]
                       if quals is not None else None),
                mate_seqs=([mcodes[i, :mlens[i]].view(np.uint8)
                            for i in range(n)] if r2 is not None else None),
                mate_quals=([mquals[i, :mlens[i]] for i in range(n)]
                            if (r2 is not None and mquals is not None)
                            else None),
                sample=sample)
    finally:
        r1.close()
        if r2 is not None:
            r2.close()
