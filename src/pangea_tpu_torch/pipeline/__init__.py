from .run import (default_sample_names, load_taxonomy_any, run_build,
                  run_classify_basic)

__all__ = ["default_sample_names", "load_taxonomy_any", "run_build",
           "run_classify_basic"]
