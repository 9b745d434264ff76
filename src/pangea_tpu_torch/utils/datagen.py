"""Synthetic test data, numpy only.

The port's copy of the parts of ``pangea_tpu/utils/datagen.py`` that the
bench world and the tests use: a rank-structured taxonomy, genomes with
genus-level shared "core" segments (forcing k-mer → LCA merges), reads
sampled from known genomes (forward/revcomp, optional N corruption,
paired-end) with a planted truth, the vectorized bulk FASTQ generator, and
FASTA/FASTQ/taxonomy-TSV writers. The same seeds give the reference's
outputs exactly (``tests/test_torch_host.py``, ``tests/test_torch_build.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..taxonomy import RANK_CODES, RANK_NAMES, Taxonomy


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


def write_taxonomy_tsv(path: str, tax: Taxonomy) -> None:
    """The taxonomy as ``Taxonomy.load_tsv`` reads it: taxid, parent, rank
    name and name a line."""
    with open(path, "w") as fh:
        fh.write("#taxid\tparent\trank\tname\n")
        for t in range(1, tax.num_taxa + 1):
            fh.write(f"{t}\t{int(tax.parent[t])}\t"
                     f"{RANK_NAMES[int(tax.rank[t])]}\t{tax.names[t]}\n")


def generate_reads_fastq_bulk(path: str, genomes, n_reads: int,
                              read_len: int = 150, paired: bool = False,
                              mate_path: str | None = None,
                              n_prob: float = 0.01, insert: int = 300,
                              revcomp_frac: float = 0.5, seed: int = 2,
                              sample_name: str = "S0", barcodes=None,
                              chunk: int = 1 << 20) -> np.ndarray:
    """Vectorized FASTQ generator for many reads: fixed-width records
    assembled as one uint8 matrix a chunk of reads. ``barcodes`` (equal
    length strings): each read gets a random one before mate 1 (a pooled
    cohort), drawn from the same generator. Writes ``<path>.truth.npy``
    (and, with barcodes, ``<path>.samples.npy``) and returns truth: int32
    [n_reads] source taxa."""
    rng = np.random.default_rng(seed)
    cat = np.concatenate([g[0] for g in genomes])
    lens = np.array([len(g[0]) for g in genomes], dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    gtax = np.array([g[1] for g in genomes], dtype=np.int32)
    span = insert if paired else read_len
    L = read_len
    bc_codes = None
    if barcodes is not None:
        if len({len(b) for b in barcodes}) != 1:
            raise ValueError("bulk generator needs equal-length barcodes")
        enc = {c: i for i, c in enumerate("ACGT")}
        bc_codes = np.array([[enc[c] for c in b] for b in barcodes],
                            dtype=np.uint8)
    digits = len(str(max(n_reads - 1, 1)))
    prefix = f"@{sample_name}.read".encode()

    def rec_matrix(ids_num, seq_codes):
        B, Ls = seq_codes.shape
        W = len(prefix) + digits
        rec = np.empty((B, W + 1 + Ls + 3 + Ls + 1), dtype=np.uint8)
        rec[:, :len(prefix)] = np.frombuffer(prefix, np.uint8)
        p10 = 10 ** np.arange(digits - 1, -1, -1, dtype=np.int64)
        rec[:, len(prefix):W] = \
            (ids_num[:, None] // p10 % 10 + ord("0")).astype(np.uint8)
        rec[:, W] = ord("\n")
        rec[:, W + 1:W + 1 + Ls] = _BASES[seq_codes]
        rec[:, W + 1 + Ls] = ord("\n")
        rec[:, W + 2 + Ls] = ord("+")
        rec[:, W + 3 + Ls] = ord("\n")
        rec[:, W + 4 + Ls:W + 4 + 2 * Ls] = 33 + 35
        rec[:, -1] = ord("\n")
        return rec

    truth = np.empty(n_reads, dtype=np.int32)
    samp = np.empty(n_reads, dtype=np.int32) if bc_codes is not None \
        else None
    f1 = open(path, "wb")
    f2 = open(mate_path, "wb") if paired else None
    try:
        for lo in range(0, n_reads, chunk):
            B = min(chunk, n_reads - lo)
            gi = rng.integers(0, len(genomes), size=B)
            hi = np.maximum(lens[gi] - span, 1)
            start = (rng.random(B) * hi).astype(np.int64)
            frag = cat[(offs[gi] + start)[:, None]
                       + np.arange(span, dtype=np.int64)[None, :]]
            r1 = frag[:, :L].copy()
            rc = rng.random(B) < revcomp_frac
            r1[rc] = 3 - r1[rc][:, ::-1]
            if n_prob > 0:
                r1[rng.random((B, L)) < n_prob] = 4
            ids_num = np.arange(lo, lo + B, dtype=np.int64)
            if bc_codes is not None:
                si = rng.integers(0, bc_codes.shape[0], size=B)
                samp[lo:lo + B] = si
                r1 = np.concatenate([bc_codes[si], r1], axis=1)
            f1.write(rec_matrix(ids_num, r1).tobytes())
            if paired:
                r2 = (3 - frag[:, -L:])[:, ::-1].copy()
                if n_prob > 0:
                    r2[rng.random((B, L)) < n_prob] = 4
                f2.write(rec_matrix(ids_num, r2).tobytes())
            truth[lo:lo + B] = gtax[gi]
    finally:
        f1.close()
        if f2 is not None:
            f2.close()
    np.save(path + ".truth.npy", truth)
    if samp is not None:
        np.save(path + ".samples.npy", samp)
    return truth
