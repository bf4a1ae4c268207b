"""Composite blocks (the port of sheeprl_tpu/nn/blocks.py): MLP and CNN, each
a stack of (linear|conv) -> [LayerNorm] -> activation miniblocks."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as tnn

from ..ops.kernels.cnn import cnn_stage_supported, conv_ln_silu
from .core import Activation, activation
from .layers import Conv2d, LayerNorm, Linear

__all__ = ["MLP", "CNN"]


class MLP(tnn.Module):
    """Linear stack with optional per-layer LayerNorm and an output head.
    Hidden miniblocks are Linear -> [LayerNorm] -> act; the head is a bare
    Linear. A layer without a norm holds an `Identity` in `norms`, so the
    parameter names match the reference's field paths."""

    def __init__(self, input_dim: int, hidden_sizes: Sequence[int], output_dim: int | None = None,
                 *, act: Activation = "tanh", layer_norm: bool = False, use_bias: bool = True,
                 norm_eps: float = 1e-5, generator: torch.Generator | None = None):
        super().__init__()
        sizes = [input_dim, *hidden_sizes]
        self.act = act
        self.layers = tnn.ModuleList(
            Linear(sizes[i], sizes[i + 1], use_bias=use_bias, generator=generator)
            for i in range(len(hidden_sizes))
        )
        self.norms = tnn.ModuleList(
            LayerNorm(s, eps=norm_eps) if layer_norm else tnn.Identity() for s in sizes[1:]
        )
        self.head = None if output_dim is None else Linear(sizes[-1], output_dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = activation(self.act)
        for layer, norm in zip(self.layers, self.norms):
            x = act(norm(layer(x)))
        if self.head is not None:
            x = self.head(x)
        return x

    @property
    def output_dim(self) -> int:
        if self.head is not None:
            return self.head.out_features
        return self.layers[-1].out_features


class CNN(tnn.Module):
    """Conv2d stack (NHWC): conv -> [LayerNorm over channels] -> act. A
    Dreamer miniblock (k4/s2/SAME conv without bias, affine LayerNorm, SiLU,
    even spatial size) runs as one fused `conv_ln_silu` kernel, under the
    reference's structural guard (sheeprl_tpu/nn/blocks.py:171-184)."""

    def __init__(self, in_channels: int, channels: Sequence[int], kernel_sizes: Sequence[int],
                 strides: Sequence[int], *, paddings: Sequence | None = None,
                 act: Activation = "relu", layer_norm: bool = False, use_bias: bool = True,
                 norm_eps: float = 1e-5, generator: torch.Generator | None = None):
        super().__init__()
        n = len(channels)
        paddings = ["SAME"] * n if paddings is None else paddings
        chans = [in_channels, *channels]
        self.act = act
        self.layers = tnn.ModuleList(
            Conv2d(chans[i], chans[i + 1], kernel_sizes[i], stride=strides[i],
                   padding=paddings[i], use_bias=use_bias, generator=generator)
            for i in range(n)
        )
        self.norms = tnn.ModuleList(
            LayerNorm(c, eps=norm_eps) if layer_norm else tnn.Identity() for c in channels
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., H, W, C]; leading dims are folded into the conv batch."""
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        act = activation(self.act)
        for layer, norm in zip(self.layers, self.norms):
            if (
                isinstance(norm, LayerNorm)
                and norm.scale is not None
                and layer.bias is None
                # even spatial dims only: the kernel computes h//2 while SAME
                # computes ceil(h/2)
                and x.shape[-3] % 2 == 0
                and x.shape[-2] % 2 == 0
                and cnn_stage_supported(layer.kernel.shape, layer.stride, layer.padding, True, self.act)
            ):
                x = conv_ln_silu(x, layer.kernel.to(x.dtype), norm.scale, norm.offset, norm.eps)
                continue
            x = act(norm(layer(x)))
        return x.reshape(lead + x.shape[1:])
