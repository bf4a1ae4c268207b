"""Primitive layers (the port of sheeprl_tpu/nn/layers.py): Linear, Conv2d,
LayerNorm.

Layouts: `Linear.weight` is torch's [out, in] (the reference keeps
[in, out]; `interop.py` transposes). Convolutions keep the reference's NHWC
activations and HWIO kernels at their interface. LayerNorm normalizes the
trailing axis in f32 with each instance's own `eps`. Parameters are f32;
the forward follows the input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as tnn
import torch.nn.functional as F

__all__ = ["Linear", "Conv2d", "LayerNorm"]


def _uniform_(t: torch.Tensor, bound: float, generator: torch.Generator | None) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class Linear(tnn.Module):
    def __init__(self, in_features: int, out_features: int, *, use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        # torch's default init: kaiming_uniform(a=sqrt(5)) = U(+-1/sqrt(fan_in))
        bound = 1.0 / math.sqrt(in_features)
        self.weight = tnn.Parameter(torch.empty(out_features, in_features))
        _uniform_(self.weight, bound, generator)
        if use_bias:
            self.bias = tnn.Parameter(torch.empty(out_features))
            _uniform_(self.bias, bound, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)

    @property
    def in_features(self) -> int:
        return self.weight.shape[1]

    @property
    def out_features(self) -> int:
        return self.weight.shape[0]


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding: out = ceil(size / s), the extra pixel (if any)
    on the high side."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(tnn.Module):
    """NHWC convolution with an HWIO kernel; padding 'SAME', 'VALID', an int
    or ((top, bottom), (left, right))."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, *, stride=1,
                 padding="SAME", use_bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        if isinstance(padding, int):
            padding = ((padding, padding), (padding, padding))
        self.padding = padding
        bound = 1.0 / math.sqrt(in_channels * kh * kw)
        self.kernel = tnn.Parameter(torch.empty(kh, kw, in_channels, out_channels))
        _uniform_(self.kernel, bound, generator)
        if use_bias:
            self.bias = tnn.Parameter(torch.empty(out_channels))
            _uniform_(self.bias, bound, generator)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        if self.padding == "SAME":
            pads = (_same_pads(x.shape[-3], kh, self.stride[0]), _same_pads(x.shape[-2], kw, self.stride[1]))
        elif self.padding == "VALID":
            pads = ((0, 0), (0, 0))
        else:
            pads = self.padding
        xc = x.permute(0, 3, 1, 2)
        (top, bottom), (left, right) = pads
        if (top, left) == (bottom, right):
            y = F.conv2d(xc, self.kernel.to(x.dtype).permute(3, 2, 0, 1), stride=self.stride,
                         padding=(top, left))
        else:
            y = F.conv2d(F.pad(xc, (left, right, top, bottom)),
                         self.kernel.to(x.dtype).permute(3, 2, 0, 1), stride=self.stride)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[:, None, None]
        return y.permute(0, 2, 3, 1).contiguous()

    @property
    def in_channels(self) -> int:
        return self.kernel.shape[2]

    @property
    def out_channels(self) -> int:
        return self.kernel.shape[3]


class LayerNorm(tnn.Module):
    """LayerNorm over the trailing axis (channels in NHWC / features), f32
    statistics, the result in the input's dtype."""

    def __init__(self, dim: int, *, eps: float = 1e-5, elementwise_affine: bool = True):
        super().__init__()
        self.dim = dim
        self.eps = eps
        if elementwise_affine:
            self.scale = tnn.Parameter(torch.ones(dim))
            self.offset = tnn.Parameter(torch.zeros(dim))
        else:
            self.register_parameter("scale", None)
            self.register_parameter("offset", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (self.dim,), self.scale, self.offset, self.eps).to(x.dtype)
