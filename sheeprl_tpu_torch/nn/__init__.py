"""Layers and blocks of the port (the counterpart of sheeprl_tpu/nn)."""

from .blocks import CNN, MLP, DeCNN, NatureCNN, StackedMLP
from .core import activation
from .layers import Conv2d, ConvTranspose2d, LayerNorm, Linear, StackedLayerNorm, StackedLinear
from .recurrent import LayerNormGRUCell

__all__ = [
    "CNN", "Conv2d", "ConvTranspose2d", "DeCNN", "LayerNorm", "LayerNormGRUCell", "Linear", "MLP",
    "NatureCNN", "StackedLayerNorm", "StackedLinear", "StackedMLP", "activation",
]
