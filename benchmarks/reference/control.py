"""The control: the reference with a lower-precision key.

The configuration guarantees exact k-mer matches (SEMANTICS.md §5: a
query hits only its own key). :class:`FingerprintMap` breaks that
guarantee the way a smaller table would: it holds the same k-mers and taxa
in NB buckets (the hash's low bits, §4) and keeps of each key only a
16-bit fingerprint, so a query takes the taxon of the first key of its
bucket, in ascending k-mer order, whose fingerprint matches its own. It
stands in for the program; the comparison that decides ``correct`` has to
find it wrong.
"""
from __future__ import annotations

import numpy as np

from .classify import KmerMap
from .kmers import M32, _mix32, hash32

FINGERPRINT_BITS = 16
KEYS_A_BUCKET = 16          # NB: the least power of two with n / NB <= 16


def _slot(keys: np.ndarray, nb: int) -> np.ndarray:
    """(bucket << 16) | fingerprint of each key: the fingerprint from a
    second mix of the key, independent of the bucket bits."""
    bucket = hash32(keys) & np.uint64(nb - 1)
    fp = _mix32((keys & M32) ^ _mix32(keys >> np.uint64(32))
                ^ np.uint64(0x5BD1E995)) >> np.uint64(32 - FINGERPRINT_BITS)
    return (bucket << np.uint64(FINGERPRINT_BITS)) | fp


class FingerprintMap(KmerMap):
    """A :class:`KmerMap` looked up by (bucket, 16-bit fingerprint)."""

    def __init__(self, exact: KmerMap):
        n = max(exact.keys.size, 1)
        self.nb = 1 << max(int(-(-n // KEYS_A_BUCKET) - 1).bit_length(), 0)
        slot = _slot(exact.keys, self.nb)
        order = np.argsort(slot, kind="stable")   # keys stay ascending
        slot = slot[order]
        first = np.ones(slot.shape[0], bool)
        first[1:] = slot[1:] != slot[:-1]
        super().__init__(slot[first], exact.taxa[order][first])

    def lookup(self, canon: np.ndarray, valid: np.ndarray) -> np.ndarray:
        return super().lookup(_slot(canon, self.nb), valid)
