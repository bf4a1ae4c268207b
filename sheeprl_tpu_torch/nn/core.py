"""Activations by name (the port of sheeprl_tpu/nn/core.py's registry):
modules store the name, as the reference does in its static fields. Also
`cast_floating`, the one leaf-casting primitive of the mixed-precision
policy (`ops/precision.py`)."""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.nn.functional as F

__all__ = ["Activation", "activation", "cast_floating"]

Activation = str | None


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # the tanh form: jax.nn.gelu's default (approximate=True)
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "relu6": F.relu6,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "gelu": _gelu,
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


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating-point tensor of `tree` (a tensor, or dicts,
    lists and tuples of them) to `dtype`; integer, bool and uint8 tensors
    and non-tensors pass through. A tensor already in `dtype` is returned
    as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree
