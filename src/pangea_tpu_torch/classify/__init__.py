from .engine import (Classifier, ClassifyConfig, DeviceIndex,
                     MultiKClassifier, classify_multik, classify_reads,
                     make_classify_fn, make_multik_classify_fn, pad_batch)
from ..kernels.score import merge_multik, merge_multik_plain

__all__ = ["Classifier", "ClassifyConfig", "DeviceIndex", "MultiKClassifier",
           "classify_multik", "classify_reads", "make_classify_fn",
           "make_multik_classify_fn", "merge_multik", "merge_multik_plain",
           "pad_batch"]
