from .semantics import (AMBIG, canonical_kmers, encode_bases, hash32_np,
                        minimizer_mask, mix32_np)

__all__ = ["AMBIG", "canonical_kmers", "encode_bases", "hash32_np",
           "minimizer_mask", "mix32_np"]
