from .run import default_sample_names, run_classify_basic

__all__ = ["default_sample_names", "run_classify_basic"]
