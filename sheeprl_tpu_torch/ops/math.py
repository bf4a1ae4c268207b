"""Core RL math of the port (the subset of sheeprl_tpu/ops/math.py that
DreamerV3 uses). The reference's reverse `lax.scan` recursions are Python
loops over time here: PyTorch runs eagerly."""

from __future__ import annotations

import torch

from .kernels.two_hot import two_hot

__all__ = ["lambda_values_dv3", "polynomial_decay", "symexp", "symlog", "two_hot"]


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * (exp(|x|) - 1)."""
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def lambda_values_dv3(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, lmbda: float = 0.95
) -> torch.Tensor:
    """DreamerV3 lambda returns over `[T, ...]` inputs (already shifted one
    step), bootstrapped from values[-1]: v_t = r_t + c_t * ((1 - lmbda) *
    V_t + lmbda * v_{t+1}), a reverse loop over T."""
    interm = rewards + continues * values * (1.0 - lmbda)
    carry = values[-1]
    out = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        carry = interm[t] + continues[t] * lmbda * carry
        out[t] = carry
    return torch.stack(out)


def polynomial_decay(
    current_step: int, *, initial: float = 1.0, final: float = 0.0, max_decay_steps: int = 100,
    power: float = 1.0,
) -> float:
    """Host-side schedule helper (exploration decay)."""
    if current_step > max_decay_steps or initial == final:
        return final
    return (initial - final) * ((1 - current_step / max_decay_steps) ** power) + final
