"""The benchmark's inputs, made from seeds: the taxonomy, the genomes and
the reads, and the wire rows the step takes.

Frozen copies of the port's generators (``utils/datagen.py``
``make_taxonomy``, ``make_genomes`` and the bulk read sampler, and
``bench.py`` ``_bench_genomes``, ``deep_genomes`` and ``pack_wire``), so
that a change to the program cannot change the yardstick: the same seeds
give the port's worlds. Reads are sampled for a whole batch at once, with
the per-read sampler's distribution: a genome uniform, a start uniform
over the genome less the span, mate 1 reverse-complemented at
``revcomp_frac``, mate 2 the reverse complement of the fragment's end,
each base N at ``n_prob``. NumPy only.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

RANK_ROOT, RANK_PHYLUM, RANK_GENUS, RANK_SPECIES = 1, 3, 7, 8


@dataclass
class World:
    """A configuration's taxonomy (``parent``, ``rank``, ``names`` over
    taxa 0..T, 0 unclassified, 1 the root) and genomes ((codes uint8,
    species taxon) each)."""
    parent: np.ndarray
    rank: np.ndarray
    names: list
    genomes: list


def make_taxonomy(n_phyla: int, genera_per_phylum: int,
                  species_per_genus: int):
    """root -> phyla -> genera -> species, numbered depth-first: (parent
    int32, rank int8, names)."""
    parent, rank = [0, 1], [0, RANK_ROOT]
    names = ["unclassified", "root"]
    for p in range(n_phyla):
        parent.append(1)
        rank.append(RANK_PHYLUM)
        names.append(f"Phylum_{p}")
        pid = len(parent) - 1
        for g in range(genera_per_phylum):
            parent.append(pid)
            rank.append(RANK_GENUS)
            names.append(f"Genus_{p}_{g}")
            gid = len(parent) - 1
            for s in range(species_per_genus):
                parent.append(gid)
                rank.append(RANK_SPECIES)
                names.append(f"Species_{p}_{g}_{s}")
    return np.array(parent, np.int32), np.array(rank, np.int8), names


def make_world(spec: dict) -> World:
    """The world a configuration's ``world`` names: a tree of
    ``tree`` = [phyla, genera a phylum, species a genus]; genomes for the
    first ``carriers`` = [genera, species] of each phylum's genera, a genus
    at a time in id order, each ``genome_len`` bases whose leading
    ``core_frac`` the genus's species share, drawn from ``genome_seed``;
    the first ``n_genomes`` of them kept."""
    n_phyla, n_genera, n_species = spec["tree"]
    c_genera, c_species = spec["carriers"]
    parent, rank, names = make_taxonomy(n_phyla, n_genera, n_species)
    ids = {name: t for t, name in enumerate(names)}
    carriers = [ids[f"Species_{p}_{g}_{s}"] for p in range(n_phyla)
                for g in range(c_genera) for s in range(c_species)]
    by_genus: dict = {}
    for s in carriers:
        by_genus.setdefault(int(parent[s]), []).append(s)
    rng = np.random.default_rng(spec["genome_seed"])
    length = spec["genome_len"]
    core_len = int(length * spec["core_frac"])
    genomes = []
    for gid in sorted(by_genus):
        if len(genomes) >= spec["n_genomes"]:
            break
        core = _random_seq(rng, core_len)
        for s in by_genus[gid]:
            genomes.append((np.concatenate(
                [core, _random_seq(rng, length - core_len)]), s))
    return World(parent, rank, names, genomes[:spec["n_genomes"]])


def _random_seq(rng, length: int) -> np.ndarray:
    return rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)


def sample_reads(genomes, n: int, traffic: dict, rng):
    """n reads (pairs where ``traffic["paired"]``) of the genomes: (codes
    uint8 [n, read_len] with 4 for N, mate codes or None, source taxa int32
    [n])."""
    L = traffic["read_len"]
    paired = traffic["paired"]
    span = traffic["insert"] if paired else L
    cat = np.concatenate([g for g, _ in genomes])
    lens = np.array([g.size for g, _ in genomes], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    gi = rng.integers(0, len(genomes), size=n)
    start = (rng.random(n) * np.maximum(lens[gi] - span, 1)).astype(np.int64)
    frag = np.lib.stride_tricks.sliding_window_view(cat, span)[
        offs[gi] + start]
    r1 = frag[:, :L].copy()
    rc = rng.random(n) < traffic["revcomp_frac"]
    r1[rc] = 3 - r1[rc][:, ::-1]
    r1[rng.random((n, L)) < traffic["n_prob"]] = 4
    r2 = None
    if paired:
        r2 = np.ascontiguousarray((3 - frag[:, -L:])[:, ::-1])
        r2[rng.random((n, L)) < traffic["n_prob"]] = 4
    taxa = np.array([t for _, t in genomes], np.int32)[gi]
    return r1, r2, taxa


def wire_width(L: int) -> int:
    """int32 words of a wire row of L bases: ceil(L/16) words of 2-bit
    codes, then ceil(L/32) words of bad flags."""
    return (L + 15) // 16 + (L + 31) // 32


def pack_wire(codes: np.ndarray, L: int) -> np.ndarray:
    """The native reader's wire rows (int32 [n, wire_width(L)]) of codes
    uint8 [n, m], m <= L: base j's 2-bit code at bits [2(j%16), +2) of
    word j//16, its bad flag (code > 3) at bit j%32 of word ceil(L/16) +
    j//32; the bases past m are bad."""
    n, m = codes.shape
    w16, w32 = (L + 15) // 16, (L + 31) // 32
    full = np.full((n, w32 * 32), 4, np.uint8)
    full[:, :m] = codes
    c = (full[:, :w16 * 16] & 3).reshape(n, w16, 4, 4)
    quads = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
    words = np.ascontiguousarray(quads).view("<u4")[..., 0]
    flags = np.packbits((full > 3).reshape(n, w32, 32), axis=2,
                        bitorder="little")
    flags = np.ascontiguousarray(flags).view("<u4")[..., 0]
    return np.concatenate([words, flags], axis=1).astype(np.uint32).view(
        np.int32)
