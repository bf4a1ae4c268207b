"""Activations by name (the port of sheeprl_tpu/nn/core.py's registry):
modules store the name, as the reference does in its static fields."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["Activation", "activation"]

Activation = str | None

_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "gelu": F.gelu,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
    "softplus": F.softplus,
    "identity": lambda x: x,
}


def activation(name: Activation) -> Callable[[torch.Tensor], torch.Tensor]:
    """Resolve an activation name to its function (None -> identity)."""
    if name is None:
        return _ACTIVATIONS["identity"]
    try:
        return _ACTIVATIONS[name]
    except KeyError as e:
        raise ValueError(f"unknown activation {name!r}; known: {sorted(_ACTIVATIONS)}") from e
