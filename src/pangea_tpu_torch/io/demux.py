"""Demultiplexing: binning a pooled run's reads to their samples, on the
host, numpy only.

The port's copy of ``pangea_tpu/io/demux.py``. A read whose first
``len(barcode)`` bases match a sample's barcode within ``max_mismatch``
(Hamming, on base codes: ambiguity codes never match) goes to that sample
with the barcode stripped; the first barcode in config order wins. Other
reads go to sample ``"undetermined"`` unstripped. Only mate 1 is read and
stripped; a mate 2 follows its read.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..core import encode_bases
from .fastx import ReadBatch

UNDETERMINED = "undetermined"


@dataclass(frozen=True)
class DemuxConfig:
    barcodes: tuple[tuple[str, str], ...]  # (sample_name, barcode) pairs
    max_mismatch: int = 0


def demux_batch(batch: ReadBatch, cfg: DemuxConfig) -> dict[str, ReadBatch]:
    """Split one batch into per-sample batches (dict keyed by sample, in
    config order then undetermined; empty samples left out)."""
    codes = [(name, encode_bases(bc)) for name, bc in cfg.barcodes]
    bins: dict[str, list[int]] = {name: [] for name, _ in cfg.barcodes}
    bins[UNDETERMINED] = []
    strip: dict[int, int] = {}
    for i, seq in enumerate(batch.seqs):
        assigned = None
        for name, bc in codes:
            if seq.size < bc.size:
                continue
            mism = int((seq[:bc.size] != bc).sum())
            if mism <= cfg.max_mismatch:
                assigned = (name, bc.size)
                break
        if assigned is None:
            bins[UNDETERMINED].append(i)
        else:
            bins[assigned[0]].append(i)
            strip[i] = assigned[1]
    out: dict[str, ReadBatch] = {}
    paired = batch.mate_seqs is not None
    for name, idxs in bins.items():
        if not idxs:
            continue
        out[name] = ReadBatch(
            ids=[batch.ids[i] for i in idxs],
            seqs=[batch.seqs[i][strip.get(i, 0):] for i in idxs],
            quals=[batch.quals[i][strip.get(i, 0):] for i in idxs]
            if batch.quals is not None else None,
            mate_seqs=[batch.mate_seqs[i] for i in idxs] if paired else None,
            mate_quals=[batch.mate_quals[i] for i in idxs]
            if (paired and batch.mate_quals is not None) else None,
            sample=name,
        )
    return out
