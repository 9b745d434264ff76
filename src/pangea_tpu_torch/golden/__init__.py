"""The golden model: SEMANTICS.md §7-§9 in plain numpy, read by read."""
from .golden import (GoldenResult, classify_read_golden,
                     classify_reads_golden, merge_multik_golden)

__all__ = ["GoldenResult", "classify_read_golden", "classify_reads_golden",
           "merge_multik_golden"]
