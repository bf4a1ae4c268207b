"""Carry the reference's parameters into the port.

The input is the JAX package's parameters as numpy arrays keyed by the JAX
module's field path (`rssm.recurrent_model.rnn.proj.weight`), flat or as
nested dicts. The port's modules use the same paths, so the mapping is one
to one; the only change of layout is `Linear.weight`, which the reference
keeps as [in, out] and torch as [out, in]. Conv kernels stay HWIO (the
port keeps NHWC/HWIO at its convolutions). The port never imports jax: the
caller flattens the JAX pytree.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as tnn

from .nn.layers import Linear

__all__ = ["flatten_params", "load_jax_params", "state_dict_from_jax"]


def flatten_params(params: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts of arrays -> {dotted path: array}."""
    flat: dict[str, np.ndarray] = {}
    for key, value in params.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(flatten_params(value, path + "."))
        else:
            flat[path] = np.asarray(value)
    return flat


def state_dict_from_jax(module: tnn.Module, params: Mapping) -> dict[str, torch.Tensor]:
    """The port `module`'s state_dict filled from the reference's `params`.
    Raises, naming the paths, on a reference parameter the port has no place
    for, on a port parameter the reference leaves unset, and on a shape that
    does not match."""
    flat = flatten_params(params)
    own = module.state_dict()
    unmapped = sorted(set(flat) - set(own))
    if unmapped:
        raise KeyError(f"reference parameters with no counterpart in the port: {unmapped}")
    unset = sorted(set(own) - set(flat))
    if unset:
        raise KeyError(f"port parameters the reference leaves unset: {unset}")
    linear_weights = {
        f"{name}.weight" if name else "weight"
        for name, m in module.named_modules()
        if isinstance(m, Linear)
    }
    out = {}
    for name, ref in own.items():
        value = flat[name].T if name in linear_weights else flat[name]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(
                f"{name}: reference shape {tuple(flat[name].shape)} does not map onto the "
                f"port's {tuple(ref.shape)}"
            )
        out[name] = torch.from_numpy(np.array(value)).to(dtype=ref.dtype, device=ref.device)
    return out


def load_jax_params(module: tnn.Module, params: Mapping) -> tnn.Module:
    """Load the reference's `params` into `module` in place; returns it."""
    module.load_state_dict(state_dict_from_jax(module, params))
    return module
