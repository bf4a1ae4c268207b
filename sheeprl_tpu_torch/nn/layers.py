"""Primitive layers (the port of sheeprl_tpu/nn/layers.py): Linear, Conv2d,
ConvTranspose2d, LayerNorm.

Layouts: `Linear.weight` is torch's [out, in] (the reference keeps
[in, out]; `interop.py` transposes). `StackedLinear` holds the `n` members
of an ensemble as one `[n, in, out]` weight, the layout of the
reference's vmapped `Linear` (no transposition), and runs them as one
batched product. Convolutions keep the reference's NHWC
activations and HWIO kernels at their interface. LayerNorm normalizes the
trailing axis in f32 with each instance's own `eps`. Parameters are f32;
the forward follows the input's dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ..ops.kernels.deconv import subpixel_deconv

__all__ = ["Linear", "Conv2d", "ConvTranspose2d", "LayerNorm", "StackedLayerNorm", "StackedLinear", "dropout"]


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


def _transpose_pads(size_k: int, s: int, padding) -> tuple[int, int]:
    """Padding of the zero-dilated input for a transposed conv, as
    `lax.conv_transpose` computes it for 'SAME' and 'VALID'."""
    if padding == "SAME":
        pad_len = size_k + s - 2
        pad_a = size_k - 1 if s > size_k - 1 else -(-pad_len // 2)
    else:  # VALID
        pad_len = size_k + s - 2 + max(size_k - s, 0)
        pad_a = size_k - 1
    return pad_a, pad_len - pad_a


class ConvTranspose2d(tnn.Module):
    """NHWC transposed convolution with an HWIO kernel: the reference's
    `lax.conv_transpose(..., transpose_kernel=False)`, i.e. a stride-1
    cross-correlation of the kernel (not flipped) over the input dilated by
    the stride. The DreamerV3 decoder's k4/s2/SAME stages take the subpixel
    form (`ops/kernels/deconv.py:subpixel_deconv`), the same regrouping as
    the reference's `_subpixel_k4s2`; other shapes dilate explicitly.
    Padding is 'SAME', 'VALID' or ((top, bottom), (left, right))."""

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
        k = self.kernel.to(x.dtype)
        if self.stride == (2, 2) and (kh, kw) == (4, 4) and self.padding == "SAME":
            y = subpixel_deconv(x, k)
        else:
            n, h, w, c = x.shape
            (sh, sw) = self.stride
            if isinstance(self.padding, str):
                pads = (_transpose_pads(kh, sh, self.padding), _transpose_pads(kw, sw, self.padding))
            else:
                pads = self.padding
            dil = x.new_zeros((n, c, (h - 1) * sh + 1, (w - 1) * sw + 1))
            dil[:, :, ::sh, ::sw] = x.permute(0, 3, 1, 2)
            (top, bottom), (left, right) = pads
            y = F.conv2d(F.pad(dil, (left, right, top, bottom)), k.permute(3, 2, 0, 1))
            y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y.contiguous()

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


class StackedLayerNorm(tnn.Module):
    """`n` LayerNorms over the trailing axis of `[n, ..., dim]`, their
    affine parameters stacked as `[n, dim]`."""

    def __init__(self, n: int, dim: int, *, eps: float = 1e-5):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.scale = tnn.Parameter(torch.ones(n, dim))
        self.offset = tnn.Parameter(torch.zeros(n, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = (x.shape[0],) + (1,) * (x.dim() - 2) + (self.dim,)
        y = F.layer_norm(x.float(), (self.dim,), None, None, self.eps)
        return (y * self.scale.view(lead) + self.offset.view(lead)).to(x.dtype)


class StackedLinear(tnn.Module):
    """`n` Linears as one `[n, in, out]` weight and `[n, out]` bias: `[B,
    in]` (one input for every member) or `[n, B, in]` -> `[n, B, out]` by
    one `torch.baddbmm`. Each member is initialised as `Linear`."""

    def __init__(self, n: int, in_features: int, out_features: int, *, generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = tnn.Parameter(torch.empty(n, in_features, out_features))
        self.bias = tnn.Parameter(torch.empty(n, out_features))
        _uniform_(self.weight, bound, generator)
        _uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.unsqueeze(0).expand(self.weight.shape[0], -1, -1)
        return torch.baddbmm(self.bias.to(x.dtype).unsqueeze(1), x, self.weight.to(x.dtype))

    @property
    def out_features(self) -> int:
        return self.weight.shape[2]


def dropout(x: torch.Tensor, u: torch.Tensor | None, rate: float) -> torch.Tensor:
    """Inverted dropout with the uniform draw `u` (x's shape) passed in: `x /
    keep` where `u < keep`, else 0, as the reference's `dropout` keeps
    `jax.random.bernoulli(key, keep)`, which is `uniform(key) < keep`.
    Without a draw (or at rate 0) the identity."""
    if u is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
