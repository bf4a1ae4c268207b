"""sheeprl_tpu_torch — the PyTorch/CUDA port of sheeprl_tpu.

The JAX package `sheeprl_tpu` is the reference; this package follows its
module layout and names, so each module's counterpart is found at the same
path there. It imports `torch`, never `jax`, and nothing of `sheeprl_tpu`.
Entry points run on the CUDA device unless the caller passes
`--device cpu`. The Pallas kernels of the reference are hand-written
CUDA C++ kernels for Hopper here (`csrc/`, bound in `ops/kernels/`).
"""

__version__ = "0.1.0"
