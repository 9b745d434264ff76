"""pangea_tpu_torch: the PyTorch/CUDA port of pangea_tpu.

The paired-end classify path on an NVIDIA H100, with the q8 and std table
layouts: hand-written CUDA kernels (``csrc/``) behind wrappers that run a
plain PyTorch version on CPU tensors (``kernels/``), the classify step
(``classify/``), the index with its builder, layout policy and device
relayouts (``index/``), a basic streaming classify run (``pipeline/``) and
the ``classify`` CLI (``cli.py``). The host code it needs — semantics,
taxonomy, index container, config, FASTQ reader, report writers and
statistics, synthetic data — is its own numpy copy of the reference's. The
JAX package ``pangea_tpu`` is the reference; this package imports nothing
of it.
"""

__version__ = "0.1.0"
SEMANTICS_VERSION = 5    # docs/SEMANTICS.md; written into every index
