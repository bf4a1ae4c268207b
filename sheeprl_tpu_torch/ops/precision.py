"""The mixed-precision policy of the train steps (the port of
sheeprl_tpu/ops/precision.py).

- bf16 compute: with `--precision bfloat16` the network forwards and
  backwards run in bfloat16. Every layer casts its f32 weights to its
  input's dtype (`nn/layers.py`), so running in bf16 means casting the
  inputs; the cast is differentiable, so gradients reach the f32
  parameters in f32.
- f32 master parameters and optimizer moments: parameters are never cast
  in place.
- f32 islands: losses, logits and distribution math, returns and moments
  run in float32; heads upcast with `to_float32` at the boundary.

Every cast is a no-op under the float32 policy.
"""

from __future__ import annotations

from typing import Any

import torch

from ..nn.core import cast_floating

__all__ = ["compute_dtype", "to_compute", "to_float32"]


def compute_dtype(precision: str) -> torch.dtype:
    """A `precision` argument -> the compute dtype."""
    if precision == "bfloat16":
        return torch.bfloat16
    if precision == "float32":
        return torch.float32
    raise ValueError(f"precision must be 'float32' or 'bfloat16', got {precision!r}")


def to_compute(tree: Any, dtype: torch.dtype) -> Any:
    """Cast the floating tensors of `tree` to the compute dtype (uint8
    pixels and integer tensors pass through)."""
    return cast_floating(tree, dtype)


def to_float32(tree: Any) -> Any:
    """Upcast head outputs to the f32 island."""
    return cast_floating(tree, torch.float32)
