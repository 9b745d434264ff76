from . import stats
from .writers import (AssignmentRecord, count_taxa_tsv, format_assignment,
                      merge_cohort, read_assignments, summarize,
                      summarize_counts, write_cohort_summary,
                      write_cohort_summary_counts, write_summary,
                      write_summary_counts)

__all__ = ["AssignmentRecord", "count_taxa_tsv", "format_assignment",
           "merge_cohort", "read_assignments", "stats", "summarize",
           "summarize_counts", "write_cohort_summary",
           "write_cohort_summary_counts", "write_summary",
           "write_summary_counts"]
