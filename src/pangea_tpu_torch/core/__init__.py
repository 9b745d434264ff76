from .semantics import (AMBIG, canonical_kmers, disjoint_query_minimizers,
                        encode_bases, hash32_np, minimizer_mask, mix32_np,
                        revcomp_codes)

__all__ = ["AMBIG", "canonical_kmers", "disjoint_query_minimizers",
           "encode_bases", "hash32_np", "minimizer_mask", "mix32_np",
           "revcomp_codes"]
