"""Elementwise math of the port (the subset of sheeprl_tpu/ops/math.py the
DreamerV3 player uses)."""

from __future__ import annotations

import torch

__all__ = ["symlog"]


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))
