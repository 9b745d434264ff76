"""The plain reference of the classify semantics (docs/SEMANTICS.md), in
NumPy alone.

It imports neither ``jax`` nor any package of the repository: it works the
k-mer-to-taxon map out from the genomes and the taxonomy's parent array
itself, and judges the program's assignments against its own.
"""
from .classify import KmerMap, classify_reads, merge_multik, score_hits
from .control import FingerprintMap
from .kmers import canonical_kmers, genome_kmers, hash32, query_probes
from .taxonomy import Tree

__all__ = ["FingerprintMap", "KmerMap", "Tree", "canonical_kmers",
           "classify_reads", "genome_kmers", "hash32", "merge_multik",
           "query_probes", "score_hits"]
