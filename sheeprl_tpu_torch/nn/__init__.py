"""Layers and blocks of the port (the counterpart of sheeprl_tpu/nn)."""

from .blocks import CNN, MLP
from .core import activation
from .layers import Conv2d, LayerNorm, Linear
from .recurrent import LayerNormGRUCell

__all__ = ["CNN", "Conv2d", "LayerNorm", "LayerNormGRUCell", "Linear", "MLP", "activation"]
