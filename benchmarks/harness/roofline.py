"""The least time a step could take on the card, from what its inputs
need: the yardstick of ``step_roofline_pct``.

Counted from the batch's reads and the index geometry the configuration
states (``indexes[i].geometry``: layout, rows, row bytes), never from the
program, so the count is the same whatever kernels implement the step:

- bytes: the wire rows once; each table row that the batch's valid
  probes reach, once; the taxonomy's tin, tout, parent and depth arrays
  (int32 [T + 1] each); the outputs (taxon, best, nvalid, int32 a read);
- operations: building each probed k-mer (K1_KMER_OPS at every k-mer
  position, K1_HASH_OPS more where w > 1; the port's ``minimize.k1_cost``
  constants), a lower bound on the step's integer work.

The least time is the larger of bytes over the card's memory bandwidth
and operations over its integer rate (PEAKS; chip_smoke.py's ``bound``).
"""
from __future__ import annotations

import numpy as np

from reference.kmers import hash32, query_probes

# Published peaks of one NVIDIA H100 SXM (data sheet, full 700 W): HBM3
# bytes/s, and the float32 rate outside the tensor cores, taken as the
# integer rate as chip_smoke.py does.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "int_ops_per_s": 67e12}}
K1_KMER_OPS, K1_HASH_OPS = 12, 18
TAX_ARRAYS = 4                 # tin, tout, parent, depth
OUT_BYTES = 12                 # taxon, best, nvalid


def bucket_of(canon: np.ndarray, k: int, geometry: dict) -> np.ndarray:
    """A probe's table row under the stated layout: hash32's low bits for
    std (SEMANTICS.md §4), the top bits of K * 0x9E3779B1 mod 2^2k for q8
    and q12 (§5.2)."""
    rows = int(geometry["rows"])
    if geometry["layout"] == "std":
        return (hash32(canon) & np.uint64(rows - 1)).astype(np.int64)
    bits = 2 * k
    h = (canon * np.uint64(0x9E3779B1)) & np.uint64((1 << bits) - 1)
    return (h >> np.uint64(bits - (rows.bit_length() - 1))).astype(np.int64)


def step_cost(reads, mates, row_words: int, n_taxa: int, indexes,
              block: int = 16384) -> tuple[int, int]:
    """(bytes, operations) of one step over reads (uint8 codes [n, L])
    and mates (or None) sent as wire rows of ``row_words`` int32 words a
    read, both mates."""
    n = reads.shape[0]
    nbytes = n * row_words * 4 + TAX_ARRAYS * (n_taxa + 1) * 4 \
        + OUT_BYTES * n
    ops = 0
    for ix in indexes:
        geo, k, w = ix["geometry"], ix["k"], ix["w"]
        reached = np.zeros(int(geo["rows"]), bool)
        for part in (reads, mates):
            if part is None:
                continue
            positions = max(part.shape[1] - k + 1, 0)
            ops += n * positions * (K1_KMER_OPS
                                    + (K1_HASH_OPS if w > 1 else 0))
            for lo in range(0, n, block):
                canon, valid = query_probes(part[lo:lo + block], k, w)
                reached[bucket_of(canon[valid], k, geo)] = True
        nbytes += int(reached.sum()) * int(geo["row_bytes"])
    return nbytes, ops


def least_ms(nbytes: int, ops: int, kind: str):
    """(least ms, "bytes" or "operations") on a card of that name, or None
    for a card the table lacks."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    by_bytes = nbytes / peak["bytes_per_s"] * 1e3
    by_ops = ops / peak["int_ops_per_s"] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")
