"""FASTA/FASTQ ingest, numpy only.

The port's copy of ``pangea_tpu/io/fastx.py``: parses plain or gzipped
FASTA/FASTQ into ``ReadBatch``es of uint8 base codes (SEMANTICS.md §1) for
``pad_batch``. Paired-end files are zipped record by record.
"""
from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass

import numpy as np

from ..core.semantics import _BASE_LUT

_QUAL_OFFSET = 33


@dataclass
class ReadBatch:
    """A host-side batch of reads (SoA; sequences as uint8 code arrays)."""
    ids: list[str]
    seqs: list[np.ndarray]
    quals: list[np.ndarray] | None = None      # phred scores, or None (FASTA)
    mate_seqs: list[np.ndarray] | None = None  # paired-end mate 2
    mate_quals: list[np.ndarray] | None = None
    sample: str | None = None                  # sample tag

    def __len__(self) -> int:
        return len(self.ids)


def _open(path: str):
    fh = open(path, "rb")
    magic = fh.read(2)
    fh.seek(0)
    if magic == b"\x1f\x8b":
        return _io.BufferedReader(gzip.GzipFile(fileobj=fh))
    return _io.BufferedReader(fh)


def sniff_format(path: str) -> str:
    with _open(path) as fh:
        first = fh.read(1)
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


class FastxReader:
    """Streaming single-file FASTA/FASTQ record iterator.

    Yields (id, seq_codes: uint8[], quals: uint8[] | None).
    """

    def __init__(self, path: str):
        self.path = path
        self.format = sniff_format(path)

    def __iter__(self):
        if self.format == "fasta":
            yield from self._iter_fasta()
        else:
            yield from self._iter_fastq()

    def _iter_fasta(self):
        rid = None
        chunks: list[bytes] = []
        with _open(self.path) as fh:
            for raw in fh:
                line = raw.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if rid is not None:
                        yield rid, _encode(b"".join(chunks)), None
                    rid = line[1:].split()[0].decode() if len(line) > 1 else ""
                    chunks = []
                else:
                    chunks.append(line)
            if rid is not None:
                yield rid, _encode(b"".join(chunks)), None

    def _iter_fastq(self):
        with _open(self.path) as fh:
            while True:
                hdr = fh.readline()
                if not hdr:
                    break
                if not hdr.startswith(b"@"):
                    raise ValueError(
                        f"{self.path}: malformed FASTQ header {hdr[:40]!r}")
                seq = fh.readline().rstrip(b"\r\n")
                plus = fh.readline()
                qual = fh.readline().rstrip(b"\r\n")
                if not plus.startswith(b"+") or len(qual) != len(seq):
                    raise ValueError(
                        f"{self.path}: malformed FASTQ record "
                        f"{hdr[:40]!r} (len(seq)={len(seq)}, "
                        f"len(qual)={len(qual)})")
                rid = hdr[1:].rstrip(b"\r\n").split()[0].decode()
                q = np.frombuffer(qual, dtype=np.uint8) - _QUAL_OFFSET
                yield rid, _encode(seq), q


def _encode(seq: bytes) -> np.ndarray:
    return _BASE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def read_batches(path: str, batch_size: int, mate_path: str | None = None,
                 sample: str | None = None):
    """Stream ReadBatches of ≤ batch_size reads (pairs count once).

    For paired-end, mate files must have records in the same order; read
    ids are taken from mate 1 (trailing /1 stripped)."""
    it1 = iter(FastxReader(path))
    it2 = iter(FastxReader(mate_path)) if mate_path else None
    while True:
        ids: list[str] = []
        seqs: list[np.ndarray] = []
        quals: list[np.ndarray] = []
        mseqs: list[np.ndarray] = []
        mquals: list[np.ndarray] = []
        any_qual = False
        for _ in range(batch_size):
            try:
                rid, s, q = next(it1)
            except StopIteration:
                break
            if it2 is not None:
                try:
                    _, s2, q2 = next(it2)
                except StopIteration:
                    raise ValueError(
                        f"{mate_path}: fewer records than {path}")
                mseqs.append(s2)
                mquals.append(q2 if q2 is not None
                              else np.zeros(0, np.uint8))
            if rid.endswith("/1") or rid.endswith("/2"):
                rid = rid[:-2]
            ids.append(rid)
            seqs.append(s)
            any_qual = any_qual or q is not None
            quals.append(q if q is not None else np.zeros(0, np.uint8))
        if not ids:
            if it2 is not None:
                try:
                    next(it2)
                except StopIteration:
                    pass
                else:
                    raise ValueError(f"{mate_path}: more records than {path}")
            return
        yield ReadBatch(
            ids=ids, seqs=seqs, quals=quals if any_qual else None,
            mate_seqs=mseqs if it2 is not None else None,
            mate_quals=mquals if (it2 is not None and any_qual) else None,
            sample=sample,
        )
