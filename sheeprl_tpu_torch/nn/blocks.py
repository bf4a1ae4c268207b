"""Composite blocks (the port of sheeprl_tpu/nn/blocks.py): MLP, CNN,
DeCNN and NatureCNN, each a stack of (linear|conv|deconv) -> [LayerNorm] ->
activation miniblocks. A Dreamer miniblock (k4/s2/SAME, no bias, affine LayerNorm,
SiLU) runs as one fused kernel under the reference's guard alone; the
kernel wrappers differentiate through their residual forwards."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as tnn

from ..ops.kernels.cnn import cnn_stage_supported, conv_ln_silu
from ..ops.kernels.deconv import deconv_ln_silu
from .core import Activation, activation
from .layers import Conv2d, ConvTranspose2d, LayerNorm, Linear, StackedLayerNorm, StackedLinear, dropout

__all__ = ["MLP", "CNN", "DeCNN", "NatureCNN", "StackedMLP"]


class MLP(tnn.Module):
    """Linear stack with optional per-layer LayerNorm and dropout and an
    output head. Hidden miniblocks are Linear -> [dropout] -> [LayerNorm] ->
    act (the reference's order, the DroQ critic's layout); the head is a
    bare Linear. A layer without a norm holds an `Identity` in `norms`, so
    the parameter names match the reference's field paths. Dropout runs
    only when the forward is given `uniforms`, one draw a hidden layer of
    that layer's output shape (`nn/layers.py:dropout`)."""

    def __init__(self, input_dim: int, hidden_sizes: Sequence[int], output_dim: int | None = None,
                 *, act: Activation = "tanh", layer_norm: bool = False, dropout_rate: float = 0.0,
                 use_bias: bool = True, norm_eps: float = 1e-5, generator: torch.Generator | None = None):
        super().__init__()
        sizes = [input_dim, *hidden_sizes]
        self.act = act
        self.dropout_rate = dropout_rate
        self.layers = tnn.ModuleList(
            Linear(sizes[i], sizes[i + 1], use_bias=use_bias, generator=generator)
            for i in range(len(hidden_sizes))
        )
        self.norms = tnn.ModuleList(
            LayerNorm(s, eps=norm_eps) if layer_norm else tnn.Identity() for s in sizes[1:]
        )
        self.head = None if output_dim is None else Linear(sizes[-1], output_dim, generator=generator)

    def forward(self, x: torch.Tensor, uniforms: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
        act = activation(self.act)
        for i, (layer, norm) in enumerate(zip(self.layers, self.norms)):
            x = layer(x)
            if uniforms is not None:
                x = dropout(x, uniforms[i], self.dropout_rate)
            x = act(norm(x))
        if self.head is not None:
            x = self.head(x)
        return x

    @property
    def output_dim(self) -> int:
        if self.head is not None:
            return self.head.out_features
        return self.layers[-1].out_features


class StackedMLP(MLP):
    """`n` MLPs of one shape as stacked `[n, ...]` parameters (the
    reference's vmapped ensemble of `MLP`s, whose leaves carry a leading
    member axis): `[B, in]` (one input for every member) or `[n, B, in]` ->
    `[n, B, out]`, each layer one batched product (`StackedLinear`). The
    miniblocks, dropout and parameter names are `MLP`'s; a dropout draw is
    `[n, B, hidden]`, each member its own."""

    def __init__(self, n: int, input_dim: int, hidden_sizes: Sequence[int], output_dim: int | None = None,
                 *, act: Activation = "relu", layer_norm: bool = False, dropout_rate: float = 0.0,
                 norm_eps: float = 1e-5, generator: torch.Generator | None = None):
        tnn.Module.__init__(self)
        sizes = [input_dim, *hidden_sizes]
        self.n = n
        self.act = act
        self.dropout_rate = dropout_rate
        self.layers = tnn.ModuleList(
            StackedLinear(n, sizes[i], sizes[i + 1], generator=generator) for i in range(len(hidden_sizes))
        )
        self.norms = tnn.ModuleList(
            StackedLayerNorm(n, s, eps=norm_eps) if layer_norm else tnn.Identity() for s in sizes[1:]
        )
        self.head = None if output_dim is None else StackedLinear(n, sizes[-1], output_dim, generator=generator)


class CNN(tnn.Module):
    """Conv2d stack (NHWC): conv -> [LayerNorm over channels] -> act. A
    Dreamer miniblock (k4/s2/SAME conv without bias, affine LayerNorm, SiLU,
    even spatial size) runs as one fused `conv_ln_silu` kernel, under the
    reference's structural guard (sheeprl_tpu/nn/blocks.py:171-184). A
    `[T, B]` lead folds time-major here (the reference folds batch-major for
    its sharding; each image maps through the same convolution either
    way)."""

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


class DeCNN(tnn.Module):
    """ConvTranspose2d stack (NHWC). The last layer has no norm/activation
    unless `act_last` (the decoder-output convention). A Dreamer miniblock
    runs as one fused `deconv_ln_silu` kernel under the reference's guard
    (sheeprl_tpu/nn/blocks.py:262-270)."""

    def __init__(self, in_channels: int, channels: Sequence[int], kernel_sizes: Sequence[int],
                 strides: Sequence[int], *, paddings: Sequence | None = None,
                 act: Activation = "relu", layer_norm: bool = False, use_bias: bool = True,
                 act_last: bool = False, norm_eps: float = 1e-5,
                 generator: torch.Generator | None = None):
        super().__init__()
        n = len(channels)
        paddings = ["SAME"] * n if paddings is None else paddings
        chans = [in_channels, *channels]
        self.act = act
        self.act_last = act_last
        self.layers = tnn.ModuleList(
            ConvTranspose2d(chans[i], chans[i + 1], kernel_sizes[i], stride=strides[i],
                            padding=paddings[i], use_bias=use_bias, generator=generator)
            for i in range(n)
        )
        self.norms = tnn.ModuleList(
            LayerNorm(c, eps=norm_eps) if layer_norm and (act_last or i < n - 1) else tnn.Identity()
            for i, c in enumerate(channels)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., H, W, C] latent grid -> [..., H', W', C'] image."""
        lead = x.shape[:-3]
        x = x.reshape((-1,) + x.shape[-3:])
        act = activation(self.act)
        last = len(self.layers) - 1
        for i, (layer, norm) in enumerate(zip(self.layers, self.norms)):
            activated = i != last or self.act_last
            if (
                isinstance(norm, LayerNorm)
                and norm.scale is not None
                and layer.bias is None
                and activated
                and cnn_stage_supported(layer.kernel.shape, layer.stride, layer.padding, True, self.act)
            ):
                x = deconv_ln_silu(x, layer.kernel.to(x.dtype), norm.scale, norm.offset, norm.eps)
                continue
            x = norm(layer(x))
            if activated:
                x = act(x)
        return x.reshape(lead + x.shape[1:])


class NatureCNN(tnn.Module):
    """The DQN-Nature encoder (NHWC): three VALID convolutions (8/4, 4/2,
    3/1; 32, 64, 64 channels times `channels_multiplier`) with ReLU and no
    norm, flattened, then a Linear to `features_dim` and ReLU. No stage
    meets the fused kernel's guard (k4/s2/SAME with LayerNorm and SiLU), so
    every stage is a plain convolution, as in the reference."""

    def __init__(self, in_channels: int, features_dim: int, *, screen_size: int = 64,
                 channels_multiplier: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        if channels_multiplier <= 0:
            raise ValueError(f"channels_multiplier must be greater than zero, given {channels_multiplier}")
        channels = [32 * channels_multiplier, 64 * channels_multiplier, 64 * channels_multiplier]
        kernels, strides = [8, 4, 3], [4, 2, 1]
        self.cnn = CNN(in_channels, channels, kernels, strides, paddings=["VALID"] * 3, act="relu",
                       generator=generator)
        side = screen_size
        for k, s in zip(kernels, strides):
            side = (side - k) // s + 1
        if side <= 0:
            raise ValueError(f"screen_size {screen_size} is too small for the NatureCNN's convolutions")
        self.fc = Linear(side * side * channels[-1], features_dim, generator=generator)
        self.act = "relu"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., H, W, C] -> [..., features_dim]."""
        lead = x.shape[:-3]
        y = self.cnn(x).reshape(lead + (-1,))
        return activation(self.act)(self.fc(y))

    @property
    def output_dim(self) -> int:
        return self.fc.out_features
