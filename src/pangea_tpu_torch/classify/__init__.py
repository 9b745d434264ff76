from .engine import (Classifier, ClassifyConfig, DeviceIndex,
                     classify_reads, make_classify_fn, pad_batch)

__all__ = ["Classifier", "ClassifyConfig", "DeviceIndex", "classify_reads",
           "make_classify_fn", "pad_batch"]
