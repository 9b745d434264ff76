from . import stats
from .writers import (AssignmentRecord, format_assignment, summarize,
                      write_cohort_summary, write_summary)

__all__ = ["AssignmentRecord", "format_assignment", "stats", "summarize",
           "write_cohort_summary", "write_summary"]
