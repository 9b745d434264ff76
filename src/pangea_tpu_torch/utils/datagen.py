"""Synthetic test data, numpy only.

The port's copy of the parts of ``pangea_tpu/utils/datagen.py`` that the
bench world and the tests use: a rank-structured taxonomy, genomes with
genus-level shared "core" segments (forcing k-mer → LCA merges), reads
sampled from known genomes (forward/revcomp, optional N corruption,
paired-end) with a planted truth, and FASTA/FASTQ writers. The same seeds
give the reference's outputs exactly (``tests/test_torch_host.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..taxonomy import RANK_CODES, Taxonomy


def make_taxonomy(n_phyla=2, genera_per_phylum=2, species_per_genus=3,
                  seed=0) -> Taxonomy:
    """Balanced rank-structured tree: root → phylum → genus → species."""
    parent = [0, 1]           # ids 0 (sentinel), 1 (root)
    rank = [0, RANK_CODES["root"]]
    names = ["unclassified", "root"]
    species_ids = []
    for p in range(n_phyla):
        parent.append(1)
        rank.append(RANK_CODES["phylum"])
        names.append(f"Phylum_{p}")
        pid = len(parent) - 1
        for g in range(genera_per_phylum):
            parent.append(pid)
            rank.append(RANK_CODES["genus"])
            names.append(f"Genus_{p}_{g}")
            gid = len(parent) - 1
            for s in range(species_per_genus):
                parent.append(gid)
                rank.append(RANK_CODES["species"])
                names.append(f"Species_{p}_{g}_{s}")
                species_ids.append(len(parent) - 1)
    tax = Taxonomy(parent=np.array(parent, np.int32),
                   rank=np.array(rank, np.int8), names=names)
    tax.species_ids = species_ids  # type: ignore[attr-defined]
    return tax


def random_seq(rng: np.random.Generator, length: int) -> np.ndarray:
    """uint8 base codes 0..3."""
    return rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)


def make_genomes(tax: Taxonomy, genome_len=4000, core_frac=0.25, seed=1):
    """Per-species genomes as (codes, taxon) pairs. Species in the same genus
    share a leading 'core' segment (→ those k-mers LCA-merge to the genus),
    the rest is species-unique."""
    rng = np.random.default_rng(seed)
    species = tax.species_ids  # type: ignore[attr-defined]
    by_genus: dict[int, list[int]] = {}
    for s in species:
        by_genus.setdefault(int(tax.parent[s]), []).append(s)
    genomes = []
    core_len = int(genome_len * core_frac)
    for gid in sorted(by_genus):
        core = random_seq(rng, core_len)
        for s in by_genus[gid]:
            uniq = random_seq(rng, genome_len - core_len)
            genomes.append((np.concatenate([core, uniq]), s))
    return genomes


@dataclass
class ReadSet:
    ids: list[str]
    seqs: list[np.ndarray]            # uint8 codes (may contain 4 = N)
    mates: list[np.ndarray] | None    # paired-end mate 2, or None
    truth: np.ndarray                 # int32 source taxon per read/pair
    quals: list[np.ndarray] = field(default_factory=list)


def sample_reads(genomes, n_reads: int, read_len=150, paired=False,
                 insert=300, n_prob=0.01, revcomp_frac=0.5, seed=2,
                 sample_name="S0") -> ReadSet:
    """Sample reads uniformly over genomes with planted truth labels."""
    rng = np.random.default_rng(seed)
    ids, seqs, mates, truth = [], [], ([] if paired else None), []
    span = insert if paired else read_len
    for i in range(n_reads):
        gi = int(rng.integers(len(genomes)))
        codes, taxon = genomes[gi]
        start = int(rng.integers(0, max(1, len(codes) - span)))
        frag = codes[start:start + span]
        r1 = frag[:read_len].copy()
        if rng.random() < revcomp_frac:
            r1 = _revcomp(r1)
        r1 = _corrupt(r1, rng, n_prob)
        ids.append(f"{sample_name}.read{i}")
        seqs.append(r1)
        if paired:
            r2 = _revcomp(frag[-read_len:].copy())
            r2 = _corrupt(r2, rng, n_prob)
            mates.append(r2)
        truth.append(taxon)
    qs = [np.full(len(s), 35, dtype=np.uint8) for s in seqs]
    return ReadSet(ids=ids, seqs=seqs, mates=mates,
                   truth=np.array(truth, np.int32), quals=qs)


def _revcomp(codes: np.ndarray) -> np.ndarray:
    out = codes[::-1].copy()
    m = out <= 3
    out[m] = 3 - out[m]
    return out


def _corrupt(codes: np.ndarray, rng, n_prob: float) -> np.ndarray:
    if n_prob > 0:
        mask = rng.random(codes.shape[0]) < n_prob
        codes = codes.copy()
        codes[mask] = 4
    return codes


def codes_to_str(codes: np.ndarray) -> str:
    return "".join("ACGTN"[c] for c in codes)


def write_fasta(path: str, genomes, tax: Taxonomy) -> None:
    """Genomes → FASTA with taxid in the header (``>id|taxid=N``)."""
    with open(path, "w") as fh:
        for i, (codes, taxon) in enumerate(genomes):
            fh.write(f">genome{i}|taxid={taxon} {tax.name(taxon)}\n")
            s = codes_to_str(codes)
            for j in range(0, len(s), 80):
                fh.write(s[j:j + 80] + "\n")


_BASES = np.frombuffer(b"ACGTN", np.uint8)


def write_fastq(path: str, rs: ReadSet, mate: int = 1) -> None:
    seqs = rs.seqs if mate == 1 else rs.mates
    with open(path, "wb") as fh:
        for rid, codes in zip(rs.ids, seqs):
            fh.write(b"@%s\n%s\n+\n%s\n" % (
                rid.encode(), _BASES[codes].tobytes(),
                bytes([33 + 35]) * len(codes)))
