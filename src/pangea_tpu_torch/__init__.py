"""pangea_tpu_torch: the PyTorch/CUDA port of pangea_tpu.

The paired-end q8 classify path on an NVIDIA H100: hand-written CUDA
kernels (``csrc/``) behind wrappers that run a plain PyTorch version on
CPU tensors (``kernels/``), the classify step (``classify/``), the q8 host
relayout (``index/``), a basic streaming classify run (``pipeline/``) and the
``classify`` CLI (``cli.py``). The JAX package ``pangea_tpu`` is the
reference; this package imports none of its jax modules.
"""

__version__ = "0.1.0"
