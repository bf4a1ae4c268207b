"""Example arguments of the Dreamer family's graphed steps (the port of
sheeprl_tpu/compile/specs.py): zero tensors of the shapes and dtypes the
steps are called with, for `CompilePlan.register(..., example=)`. Every
Dreamer trains on `[T, B]` sequential samples of one key layout (the
observation keys, the actions and scalar columns), and every player takes
one observation row an env, so these functions live here once.

Pixels are uint8 and every other key float32, as the mains hand them over
(the reference's rule: a float64 space lands as float32 on the device).
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import torch

__all__ = ["dict_obs_spec", "dreamer_sample_spec"]


def _dtype(key: str, cnn_keys: Sequence[str]) -> torch.dtype:
    return torch.uint8 if key in cnn_keys else torch.float32


def dict_obs_spec(obs_space: Any, keys: Sequence[str], cnn_keys: Sequence[str], lead: tuple, device) -> dict:
    """Zero observations `[*lead, *shape]` a key: a player step's `obs`."""
    return {k: torch.zeros(tuple(lead) + tuple(obs_space[k].shape), dtype=_dtype(k, cnn_keys), device=device)
            for k in keys}


def dreamer_sample_spec(obs_space: Any, obs_keys: Sequence[str], cnn_keys: Sequence[str], T: int, B: int,
                        act_sum: int, device, extra: Iterable[str] = ("rewards", "dones")) -> dict:
    """A zero `[T, B, ...]` replay sample: the observation keys, `actions`
    `[T, B, act_sum]` and each `extra` key `[T, B, 1]`, float32."""
    spec = dict_obs_spec(obs_space, obs_keys, cnn_keys, (T, B), device)
    spec["actions"] = torch.zeros((T, B, act_sum), device=device)
    spec.update({k: torch.zeros((T, B, 1), device=device) for k in extra})
    return spec
