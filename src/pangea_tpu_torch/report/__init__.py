from . import stats
from .writers import (AssignmentRecord, format_assignment,
                      summarize_counts, write_cohort_summary_counts,
                      write_summary_counts)

__all__ = ["AssignmentRecord", "format_assignment", "stats",
           "summarize_counts", "write_cohort_summary_counts",
           "write_summary_counts"]
