"""Xavier (Glorot) re-initialization of built modules (the port of
sheeprl_tpu/nn/inits.py:init_xavier, the Dreamer-family init)."""

from __future__ import annotations

import math

import torch
import torch.nn as tnn

from .layers import Conv2d, Linear

__all__ = ["init_xavier"]


def init_xavier(module: tnn.Module, generator: torch.Generator | None, mode: str = "normal") -> tnn.Module:
    """Xavier init of every Linear / Conv2d weight under `module` (in
    `modules()` order) with zero biases. `mode`: 'normal' | 'uniform'.
    Returns `module`, changed in place."""
    if mode not in ("normal", "uniform"):
        raise ValueError(f"unknown xavier init mode {mode!r}")
    with torch.no_grad():
        for layer in module.modules():
            if isinstance(layer, Linear):
                w = layer.weight
                fan_in, fan_out = layer.in_features, layer.out_features
            elif isinstance(layer, Conv2d):
                w = layer.kernel  # HWIO: fans include the receptive field
                kh, kw, cin, cout = w.shape
                fan_in, fan_out = cin * kh * kw, cout * kh * kw
            else:
                continue
            if mode == "uniform":
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                w.uniform_(-bound, bound, generator=generator)
            else:
                w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)
            if layer.bias is not None:
                layer.bias.zero_()
    return module
