"""The golden model: the frozen classification semantics
(docs/SEMANTICS.md §7-§9) in plain numpy, one read at a time.

The port's copy of ``pangea_tpu/golden/golden.py``, with its names and
rules: a read's canonical k-mers (or, for w > 1, its disjoint windows'
minimizers) are looked up on the host (``Index.lookup_np``), every hit
taxon scores the taxa it is an ancestor-or-self of, the winners' LCA is
the call, and the confidence threshold is one float32 multiply-compare.
It is deliberately simple and slow; the step, its kernels and their plain
versions are held to it bit for bit (``tests/test_torch_golden.py`` holds
it to the reference's on the CPU, ``chip_smoke.py`` holds the card's
steps to it on their first reads).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import canonical_kmers, disjoint_query_minimizers
from ..index import Index
from ..taxonomy import Taxonomy


@dataclass
class GoldenResult:
    taxon: int      # assigned taxon (0 = unclassified) after the threshold
    best: int       # the winning path score
    nvalid: int     # valid k-mer positions (the confidence denominator)

    @property
    def conf(self) -> float:
        """The reported confidence (SEMANTICS.md §7.7)."""
        if self.nvalid == 0:
            return 0.0
        return float(np.float32(self.best) / np.float32(self.nvalid))


def _score_hits(taxa_hits: np.ndarray, nvalid: int, taxonomy: Taxonomy,
                confidence_threshold: float) -> GoldenResult:
    """SEMANTICS.md §7 on a flat array of per-position hit taxa (0 = miss)."""
    hits = taxa_hits[taxa_hits != 0]
    if nvalid == 0 or hits.size == 0:
        return GoldenResult(0, 0, int(nvalid))
    cand, counts = np.unique(hits, return_counts=True)
    tin, tout = taxonomy.tin, taxonomy.tout
    # pscore(t) = the hit taxa a (with multiplicity) that are
    # ancestor-or-self of t (SEMANTICS.md §7.1).
    anc = (tin[cand][:, None] <= tin[cand][None, :]) & \
          (tin[cand][None, :] < tout[cand][:, None])
    pscore = (counts[:, None] * anc).sum(axis=0)
    best = int(pscore.max())
    winners = cand[pscore == best]
    assigned = taxonomy.lca_many(winners)
    # The threshold: one IEEE float32 multiply-compare (SEMANTICS.md §7.6).
    below = np.float32(best) < np.float32(confidence_threshold) \
        * np.float32(nvalid)
    return GoldenResult(int(0 if below else assigned), best, int(nvalid))


def _read_hits(codes: np.ndarray, index: Index):
    """One sequence → (per-probe hit taxa int32, nvalid): one probe per
    valid k-mer position for w = 1, one per valid disjoint window for w >
    1 (SEMANTICS.md §3 v4)."""
    k, w = index.meta.k, index.meta.w
    canon, valid = canonical_kmers(np.asarray(codes, dtype=np.uint8), k)
    if w <= 1 or canon.shape[0] == 0:
        return index.lookup_np(canon, valid), int(valid.sum())
    pos, wvalid = disjoint_query_minimizers(canon, valid, w)
    return index.lookup_np(canon[pos], wvalid), int(wvalid.sum())


def classify_read_golden(codes, index: Index, confidence_threshold: float,
                         mate_codes=None) -> GoldenResult:
    """Classify one read (or pair, SEMANTICS.md §8) against an index."""
    taxa, nvalid = _read_hits(codes, index)
    if mate_codes is not None:
        taxa2, nvalid2 = _read_hits(mate_codes, index)
        taxa = np.concatenate([taxa, taxa2])
        nvalid += nvalid2
    return _score_hits(taxa, nvalid, index.taxonomy, confidence_threshold)


def classify_reads_golden(reads, index: Index, confidence_threshold: float,
                          mates=None) -> list[GoldenResult]:
    if mates is None:
        return [classify_read_golden(r, index, confidence_threshold)
                for r in reads]
    return [classify_read_golden(r, index, confidence_threshold, mate_codes=m)
            for r, m in zip(reads, mates)]


def merge_multik_golden(r1: GoldenResult, r2: GoldenResult,
                        taxonomy: Taxonomy) -> GoldenResult:
    """SEMANTICS.md §9: merge two classifiers' (taxon, best, nvalid) of a
    read. Confidences compare as exact rationals by integer
    cross-multiplication; ties pick r1."""
    t1, t2 = r1.taxon, r2.taxon
    if t1 == 0 and t2 == 0:
        return GoldenResult(0, 0, r1.nvalid + r2.nvalid)
    if t1 == 0:
        return GoldenResult(t2, r2.best, r2.nvalid)
    if t2 == 0:
        return GoldenResult(t1, r1.best, r1.nvalid)
    x1 = r1.best * r2.nvalid
    x2 = r2.best * r1.nvalid
    if t1 == t2:
        keep = r1 if x1 >= x2 else r2        # higher confidence; tie → r1
        return GoldenResult(t1, keep.best, keep.nvalid)
    keep = r1 if x1 <= x2 else r2            # lower confidence; tie → r1
    return GoldenResult(taxonomy.lca(t1, t2), keep.best, keep.nvalid)
