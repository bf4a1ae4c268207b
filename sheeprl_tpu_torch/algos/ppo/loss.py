"""PPO losses (the port of sheeprl_tpu/algos/ppo/loss.py), each with the
reductions mean, sum and none."""

from __future__ import annotations

import torch

__all__ = ["entropy_loss", "policy_loss", "value_loss"]


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    if reduction == "none":
        return x
    raise ValueError(f"unrecognized reduction: {reduction}")


def policy_loss(new_logprobs: torch.Tensor, old_logprobs: torch.Tensor, advantages: torch.Tensor,
                clip_coef: float, reduction: str = "mean") -> torch.Tensor:
    """The clipped surrogate objective, eq. (7) of arXiv:1707.06347."""
    ratio = torch.exp(new_logprobs - old_logprobs)
    pg1 = advantages * ratio
    pg2 = advantages * torch.clamp(ratio, 1.0 - clip_coef, 1.0 + clip_coef)
    return _reduce(-torch.minimum(pg1, pg2), reduction)


def value_loss(new_values: torch.Tensor, old_values: torch.Tensor, returns: torch.Tensor, clip_coef: float,
               clip_vloss: bool, reduction: str = "mean") -> torch.Tensor:
    """The value error, optionally clipped around the old values. Both forms
    are the squared error without the 0.5 factor, as in the reference."""
    values_pred = old_values + torch.clamp(new_values - old_values, -clip_coef, clip_coef) if clip_vloss \
        else new_values
    return _reduce(torch.square(values_pred - returns), reduction)


def entropy_loss(entropy: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    return _reduce(-entropy, reduction)
