"""The synthetic bench world of the classify path.

Counterpart of ``pangea_tpu/bench.py`` ``make_bench_world``: the config-2
scale world (two phyla of 8 genera of 3 species, 50 kb genomes whose genus
mates share a core, paired 150 bp reads with planted truth), drawn from the
same seeds through the reference's jax-free host code, so its first
``n_reads`` pairs are the reference bench's. It differs in three ways: the
index is built at the minimizer window ``w`` the port classifies with, no
world is cached on disk, and only as many pairs are drawn as asked for.
"""
from __future__ import annotations

from dataclasses import dataclass

from pangea_tpu.index import Index, build_index
from pangea_tpu.taxonomy import Taxonomy
from pangea_tpu.utils import datagen


@dataclass
class BenchWorld:
    taxonomy: Taxonomy
    index: Index
    reads: datagen.ReadSet        # paired: reads.mates holds mate 2


def make_bench_world(n_reads: int = 100_000, read_len: int = 150,
                     n_species: int = 48, genome_len: int = 50_000,
                     k: int = 21, w: int = 8, seed: int = 0) -> BenchWorld:
    """The bench world with its index at (k, w) and n_reads read pairs."""
    per_genus = 3
    genera = max(n_species // per_genus // 2, 1)
    tax = datagen.make_taxonomy(n_phyla=2, genera_per_phylum=genera,
                                species_per_genus=per_genus, seed=seed)
    genomes = datagen.make_genomes(tax, genome_len=genome_len,
                                   seed=seed + 1)
    idx = build_index(genomes, tax, k=k, w=w)
    rs = datagen.sample_reads(genomes, n_reads, read_len=read_len,
                              paired=True, n_prob=0.005, seed=seed + 2)
    return BenchWorld(tax, idx, rs)


def write_fastq_pair(reads: datagen.ReadSet, path1: str, path2: str) -> None:
    """Mate 1 and mate 2 of a paired read set as two FASTQ files."""
    datagen.write_fastq(path1, reads, mate=1)
    datagen.write_fastq(path2, reads, mate=2)
