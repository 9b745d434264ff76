"""The k-mer-to-taxon map and the per-read score (SEMANTICS.md §5-§9).

:class:`KmerMap` holds every k-mer the build side selects from the genomes
(§3), each with the LCA of the taxa whose genomes hold it (§5), as a
sorted array. A read's probes look up in it; §7 scores the hits: every
hit taxon votes for the taxa it is an ancestor-or-self of, the LCA of the
best-voted hit taxa is the call, and a call under the confidence threshold
(one float32 multiply-compare) is unclassified. Pairs score their mates'
probes together (§8); several indexes merge left to right (§9).
"""
from __future__ import annotations

import os

import numpy as np

from .kmers import genome_kmers, query_probes
from .taxonomy import Tree

ROWS_A_BLOCK = 4096         # reads scored together


class KmerMap:
    """Sorted distinct k-mers (uint64) and their taxa (int64)."""

    def __init__(self, keys: np.ndarray, taxa: np.ndarray):
        self.keys = keys
        self.taxa = taxa

    @classmethod
    def build(cls, genomes, tree: Tree, k: int, w: int) -> "KmerMap":
        """genomes: a list of (codes uint8 [n], taxon). A k-mer held by
        several genomes maps to the LCA of their taxa."""
        per = [genome_kmers(codes, k, w) for codes, _ in genomes]
        gtax = np.array([t for _, t in genomes], np.int64)
        gbits = max(int(len(genomes) - 1).bit_length(), 1)
        if 2 * k + gbits <= 64:            # sort one packed array
            packed = np.sort(np.concatenate(
                [(km << np.uint64(gbits)) | np.uint64(g)
                 for g, km in enumerate(per)]))
            packed = packed[np.append(True, packed[1:] != packed[:-1])]
            keys = packed >> np.uint64(gbits)
            owner = (packed & np.uint64((1 << gbits) - 1)).astype(np.int64)
        else:
            keys = np.concatenate(per)
            owner = np.repeat(np.arange(len(per)), [p.size for p in per])
            order = np.lexsort((owner, keys))
            keys, owner = keys[order], owner[order]
            once = np.ones(keys.shape[0], bool)
            once[1:] = (keys[1:] != keys[:-1]) | (owner[1:] != owner[:-1])
            keys, owner = keys[once], owner[once]
        taxa = gtax[owner]
        new = np.ones(keys.shape[0], bool)
        new[1:] = keys[1:] != keys[:-1]
        starts = np.flatnonzero(new)
        size = np.diff(np.append(starts, keys.shape[0]))
        out = taxa[starts]
        for j in range(1, int(size.max(initial=1))):
            more = np.flatnonzero(size > j)
            out[more] = tree.lca(out[more], taxa[starts[more] + j])
        return cls(keys[starts], out)

    def save(self, path: str) -> None:
        """Keep the map in ``path`` (an .npz), written whole or not at
        all."""
        part = path + ".partial.npz"
        np.savez(part, keys=self.keys, taxa=self.taxa.astype(np.int32))
        os.replace(part, path)

    @classmethod
    def load(cls, path: str) -> "KmerMap":
        with np.load(path) as z:
            return cls(z["keys"], z["taxa"].astype(np.int64))

    def lookup(self, canon: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """The taxon of each probe (0: a miss or an invalid probe), like
        canon's shape."""
        if self.keys.size == 0:
            return np.zeros(canon.shape, np.int64)
        flat = canon.reshape(-1)
        order = np.argsort(flat)
        q = flat[order]
        at = np.minimum(np.searchsorted(self.keys, q), self.keys.size - 1)
        got = np.zeros(flat.shape, np.int64)
        got[order] = np.where(self.keys[at] == q, self.taxa[at], 0)
        return np.where(valid, got.reshape(canon.shape), 0)


def score_hits(hits: np.ndarray, nvalid: np.ndarray, tree: Tree,
               threshold: float):
    """§7 on hit taxa [n, R] (0 a miss) and valid counts [n]: (taxon,
    best, nvalid) int64 [n]."""
    n = hits.shape[0]
    taxon = np.zeros(n, np.int64)
    best = np.zeros(n, np.int64)
    for lo in range(0, n, ROWS_A_BLOCK):
        h = hits[lo:lo + ROWS_A_BLOCK]
        b = h.shape[0]
        cand = np.unique(h[h > 0])
        if cand.size == 0:
            continue
        col = np.searchsorted(cand, h)
        rows = np.repeat(np.arange(b), h.shape[1]).reshape(h.shape)
        counts = np.bincount((rows * cand.size + col)[h > 0],
                             minlength=b * cand.size).reshape(b, cand.size)
        anc = tree.is_ancestor_or_self(cand[:, None], cand[None, :])
        pscore = counts.astype(np.float64) @ anc.astype(np.float64)
        pscore = np.where(counts > 0, pscore, -1.0)
        top = pscore.max(axis=1)
        win = pscore == top[:, None]
        call = cand[np.argmax(win, axis=1)]
        multi = np.flatnonzero(win.sum(axis=1) > 1)
        if multi.size:
            call[multi] = 0
            for j in range(cand.size):
                on = multi[win[multi, j]]
                call[on] = tree.lca(call[on], cand[j])
        some = top > 0
        taxon[lo:lo + b] = np.where(some, call, 0)
        best[lo:lo + b] = np.where(some, top, 0).astype(np.int64)
    nvalid = np.asarray(nvalid, np.int64)
    none = nvalid == 0
    taxon[none], best[none] = 0, 0
    below = best.astype(np.float32) < (np.float32(threshold)
                                       * nvalid.astype(np.float32))
    taxon[below] = 0
    return taxon, best, nvalid


def classify_reads(maps, reads, mates, tree: Tree, indexes):
    """Reads (uint8 codes [n, L], 4 or more a bad base) and their mates
    (or None) against one map an index, merged left to right (§9).
    ``indexes`` holds each index's dict with ``k``, ``w`` and
    ``confidence_threshold``. Returns (taxon, best, nvalid) int64 [n]."""
    out = None
    for kmap, ix in zip(maps, indexes, strict=True):
        canon, valid = query_probes(reads, ix["k"], ix["w"])
        if mates is not None:
            c2, v2 = query_probes(mates, ix["k"], ix["w"])
            canon = np.concatenate([canon, c2], axis=1)
            valid = np.concatenate([valid, v2], axis=1)
        res = score_hits(kmap.lookup(canon, valid), valid.sum(axis=1), tree,
                         ix["confidence_threshold"])
        out = res if out is None else merge_multik(out, res, tree)
    return out


def merge_multik(r1, r2, tree: Tree):
    """§9: merge two calls (taxon, best, nvalid) a read; confidences
    compare by cross-multiplication, ties keep the first."""
    t1, b1, n1 = r1
    t2, b2, n2 = r2
    x1, x2 = b1 * n2, b2 * n1
    same = t1 == t2
    keep1 = np.where(same, x1 >= x2, x1 <= x2)
    taxon = np.where(same, t1, tree.lca(t1, t2))
    best = np.where(keep1, b1, b2)
    nvalid = np.where(keep1, n1, n2)
    only1 = (t1 != 0) & (t2 == 0)
    only2 = (t1 == 0) & (t2 != 0)
    neither = (t1 == 0) & (t2 == 0)
    taxon = np.where(only1, t1, np.where(only2, t2, taxon))
    best = np.where(only1, b1, np.where(only2, b2, best))
    nvalid = np.where(only1, n1, np.where(only2, n2, nvalid))
    taxon = np.where(neither, 0, taxon)
    best = np.where(neither, 0, best)
    nvalid = np.where(neither, n1 + n2, nvalid)
    return taxon, best, nvalid
