"""Report writers, numpy only.

The port's copy of ``pangea_tpu/report/writers.py``: per-read assignment
lines, reading them back (``read_assignments``, and ``count_taxa_tsv`` for
files of many millions of lines), the clade-rollup summaries and the
cohort table, from per-taxon counts or from assigned taxa, exactly per
SEMANTICS.md §10 — byte-stable output (fixed ordering, fixed float
formatting), since the reports are what is compared with the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..taxonomy import RANK_NAMES, Taxonomy


@dataclass
class AssignmentRecord:
    read_id: str
    taxon: int
    best: int
    nvalid: int

    def conf(self) -> np.float32:
        if self.nvalid == 0:
            return np.float32(0.0)
        return np.float32(self.best) / np.float32(self.nvalid)


def format_assignment(r: AssignmentRecord, taxonomy: Taxonomy) -> str:
    """One SEMANTICS.md §10.1 assignment line."""
    if r.taxon != 0:
        flag = "C"
        rank = RANK_NAMES[int(taxonomy.rank[r.taxon])]
        name = taxonomy.names[r.taxon]
    else:
        flag, rank, name = "U", "no_rank", "unclassified"
    conf = float(r.conf())
    return (f"{flag}\t{r.read_id}\t{r.taxon}\t{rank}\t{name}\t"
            f"{r.best}/{r.nvalid}\t{conf:.6f}\n")


def read_assignments(path: str):
    """Parse a §10.1 TSV back into AssignmentRecords (for `report` runs on
    existing outputs and for cohort merges)."""
    out = []
    with open(path) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            flag, rid, taxon, _rank, _name, frac, _conf = parts
            best, nvalid = frac.split("/")
            out.append(AssignmentRecord(rid, int(taxon), int(best),
                                        int(nvalid)))
    return out


def count_taxa_tsv(path: str, num_taxa: int,
                   chunk_lines: int = 1 << 20) -> np.ndarray:
    """Per-taxon direct counts (int64 [num_taxa + 1], index 0 =
    unclassified) of a §10.1 assignment TSV, read in chunks of about
    chunk_lines lines: bounded memory and no Python object a line, for the
    100M-read files of a resumed cohort run."""
    counts = np.zeros(num_taxa + 1, dtype=np.int64)
    with open(path, "rb") as fh:
        while True:
            lines = fh.readlines(chunk_lines * 64)
            if not lines:
                break
            # The taxon is the third column (flag, read id, taxon, ...).
            taxa = np.array([ln.split(b"\t", 3)[2] for ln in lines],
                            dtype=np.int64)
            counts += np.bincount(taxa, minlength=num_taxa + 1)
    return counts


def summarize_counts(direct: np.ndarray, taxonomy: Taxonomy):
    """Clade rollup from per-taxon direct counts (int64[T+1], index 0 =
    unclassified). Returns (direct, clade); clade[t] counts reads assigned
    to t or any descendant (Euler-interval prefix sums)."""
    T = taxonomy.num_taxa
    direct = np.asarray(direct, dtype=np.int64)
    by_tin = np.zeros(T + 1, dtype=np.int64)
    by_tin[taxonomy.tin[1:]] = direct[1:]
    cs = np.concatenate([[0], np.cumsum(by_tin[:T])])
    clade = np.zeros(T + 1, dtype=np.int64)
    clade[1:] = cs[taxonomy.tout[1:]] - cs[taxonomy.tin[1:]]
    clade[0] = direct[0]
    return direct, clade


def summarize(taxa: np.ndarray, taxonomy: Taxonomy):
    """Per-taxon direct and clade counts from assigned taxa (0 allowed)."""
    direct = np.bincount(taxa, minlength=taxonomy.num_taxa + 1)
    return summarize_counts(direct, taxonomy)


def write_summary(path: str, taxa: np.ndarray, taxonomy: Taxonomy) -> None:
    """SEMANTICS.md §10.2 clade-rollup summary of one sample from its
    assigned taxa."""
    direct = np.bincount(np.asarray(taxa, dtype=np.int64),
                         minlength=taxonomy.num_taxa + 1)
    write_summary_counts(path, direct, taxonomy)


def write_summary_counts(path: str, direct: np.ndarray,
                         taxonomy: Taxonomy) -> None:
    """SEMANTICS.md §10.2 clade-rollup summary of one sample from its
    per-taxon direct counts (int64 [T+1], index 0 = unclassified)."""
    direct, clade = summarize_counts(direct, taxonomy)
    total = int(direct.sum())
    with open(path, "w") as fh:
        fh.write(_summary_line(100.0 * direct[0] / total if total else 0.0,
                               int(direct[0]), int(direct[0]), "no_rank", 0,
                               0, "unclassified"))
        for t in _dfs_order(taxonomy):
            if clade[t] == 0:
                continue
            pct = 100.0 * clade[t] / total if total else 0.0
            fh.write(_summary_line(
                pct, int(clade[t]), int(direct[t]),
                RANK_NAMES[int(taxonomy.rank[t])], int(t),
                int(taxonomy.depth[t]), taxonomy.names[t]))


def _summary_line(pct, clade, direct, rank, taxid, depth, name) -> str:
    return (f"{pct:.2f}\t{clade}\t{direct}\t{rank}\t{taxid}\t"
            f"{'  ' * depth}{name}\n")


def _dfs_order(taxonomy: Taxonomy) -> np.ndarray:
    """Taxa 1..T in DFS (tin) order."""
    return np.argsort(taxonomy.tin[1:], kind="stable") + 1


def merge_cohort(sample_taxa: dict[str, np.ndarray], taxonomy: Taxonomy):
    """SEMANTICS.md §10.3: each sample's (direct, clade) counts."""
    return {name: summarize(np.asarray(t, dtype=np.int64), taxonomy)
            for name, t in sample_taxa.items()}


def write_cohort_summary(path: str, sample_taxa: dict[str, np.ndarray],
                         taxonomy: Taxonomy, sample_order=None) -> None:
    """Cohort table from per-sample assigned-taxa arrays."""
    counts = {n: np.bincount(np.asarray(t, dtype=np.int64),
                             minlength=taxonomy.num_taxa + 1)
              for n, t in sample_taxa.items()}
    write_cohort_summary_counts(path, counts, taxonomy,
                                sample_order=sample_order)


def write_cohort_summary_counts(path: str, sample_direct: dict,
                                taxonomy: Taxonomy,
                                sample_order=None) -> None:
    """Cohort table (SEMANTICS.md §10.3) from per-sample direct counts: one
    row per taxon (DFS order), clade counts per sample column; samples in
    the given order (default: insertion order)."""
    names = list(sample_order) if sample_order else list(sample_direct)
    per = {n: summarize_counts(d, taxonomy)
           for n, d in sample_direct.items()}
    with open(path, "w") as fh:
        fh.write("taxid\trank\tname\t" + "\t".join(names) + "\n")
        row0 = [str(int(per[n][0][0])) for n in names]
        fh.write("0\tno_rank\tunclassified\t" + "\t".join(row0) + "\n")
        for t in _dfs_order(taxonomy):
            counts = [int(per[n][1][t]) for n in names]
            if not any(counts):
                continue
            fh.write(f"{int(t)}\t{RANK_NAMES[int(taxonomy.rank[t])]}\t"
                     f"{taxonomy.names[t]}\t"
                     + "\t".join(str(c) for c in counts) + "\n")
