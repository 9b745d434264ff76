"""Quality trimming and length filtering on the host, numpy only.

The port's copy of ``pangea_tpu/io/trim.py``:

- 3'-end quality trim: cut the read at the first position where the mean
  phred over a sliding window of ``window`` drops below ``min_qual``
  (scanning 5'→3'; the window anchored at each position). FASTA (no
  quals) passes through.
- ``max_len``: reads longer are cut to it.
- Length filter: reads shorter than ``min_len`` after trimming are dropped
  (for pairs: the pair is dropped if either mate fails).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .fastx import ReadBatch


@dataclass(frozen=True)
class TrimConfig:
    min_qual: float = 0.0    # 0 → no quality trimming
    window: int = 4
    min_len: int = 0         # 0 → no length filter
    max_len: int = 0         # 0 → no truncation; else hard-truncate


def _trim_one(seq: np.ndarray, qual: np.ndarray | None,
              cfg: TrimConfig):
    if cfg.min_qual > 0 and qual is not None and qual.size == seq.size \
            and seq.size >= cfg.window:
        w = cfg.window
        cs = np.concatenate([[0], np.cumsum(qual.astype(np.int64))])
        means = (cs[w:] - cs[:-w]) / w
        bad = np.flatnonzero(means < cfg.min_qual)
        if bad.size:
            cut = int(bad[0])
            seq = seq[:cut]
            qual = qual[:cut]
    if cfg.max_len and seq.size > cfg.max_len:
        seq = seq[:cfg.max_len]
        qual = qual[:cfg.max_len] if qual is not None else None
    return seq, qual


def trim_batch(batch: ReadBatch, cfg: TrimConfig) -> ReadBatch:
    """Trim and filter a batch; returns a new batch (input order kept), or
    the batch itself when cfg does nothing."""
    if cfg.min_qual <= 0 and not cfg.min_len and not cfg.max_len:
        return batch
    keep_ids, seqs, quals, mseqs, mquals = [], [], [], [], []
    paired = batch.mate_seqs is not None
    for i in range(len(batch)):
        q = batch.quals[i] if batch.quals is not None else None
        s, q = _trim_one(batch.seqs[i], q, cfg)
        if paired:
            q2 = batch.mate_quals[i] if batch.mate_quals is not None else None
            s2, q2 = _trim_one(batch.mate_seqs[i], q2, cfg)
            if cfg.min_len and (s.size < cfg.min_len or
                                s2.size < cfg.min_len):
                continue
            mseqs.append(s2)
            mquals.append(q2 if q2 is not None else np.zeros(0, np.uint8))
        elif cfg.min_len and s.size < cfg.min_len:
            continue
        keep_ids.append(batch.ids[i])
        seqs.append(s)
        quals.append(q if q is not None else np.zeros(0, np.uint8))
    return ReadBatch(
        ids=keep_ids, seqs=seqs,
        quals=quals if batch.quals is not None else None,
        mate_seqs=mseqs if paired else None,
        mate_quals=mquals if (paired and batch.mate_quals is not None)
        else None,
        sample=batch.sample,
    )
