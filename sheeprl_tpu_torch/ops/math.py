"""Core RL math of the port (the subset of sheeprl_tpu/ops/math.py that
the Dreamer family and PPO use). The reference's reverse `lax.scan` recursions are
Python loops over time here: PyTorch runs eagerly."""

from __future__ import annotations

import torch

from .kernels.two_hot import two_hot

__all__ = [
    "gae", "lambda_values", "lambda_values_dv2", "lambda_values_dv3", "normalize", "polynomial_decay", "symexp", "symlog",
    "two_hot",
]


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * (exp(|x|) - 1)."""
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def gae(
    rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor, next_value: torch.Tensor,
    next_done: torch.Tensor, gamma: float, gae_lambda: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation (arXiv:1506.02438) over time-major
    `[T, ...]` rewards, values and dones; `next_value` and `next_done`
    bootstrap the step after the rollout. `dones[t]` is the done flag
    entering step t, so step t continues into t + 1 unless `dones[t + 1]`
    (or `next_done` at the last step). -> (returns, advantages), `[T, ...]`."""
    dones = dones.float()
    next_nonterminal = torch.cat([1.0 - dones[1:], (1.0 - next_done.float())[None]], dim=0)
    next_values = torch.cat([values[1:], next_value[None]], dim=0)
    deltas = rewards + gamma * next_values * next_nonterminal - values
    carry = torch.zeros_like(next_value)
    advantages = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        carry = deltas[t] + gamma * gae_lambda * next_nonterminal[t] * carry
        advantages[t] = carry
    advantages = torch.stack(advantages)
    return advantages + values, advantages


def normalize(x: torch.Tensor, eps: float = 1e-8, mask: torch.Tensor | None = None) -> torch.Tensor:
    """(x - mean) / (std + eps), the statistics over the entries `mask`
    selects (all when None); std is the population one, as `jnp.std`."""
    if mask is None:
        mean, std = x.mean(), x.std(correction=0)
    else:
        mask = mask.float()
        n = mask.sum().clamp_min(1.0)
        mean = (x * mask).sum() / n
        std = torch.sqrt((torch.square(x - mean) * mask).sum() / n)
    return (x - mean) / (std + eps)


def lambda_values(
    rewards: torch.Tensor, values: torch.Tensor, done_mask: torch.Tensor, last_values: torch.Tensor,
    horizon: int, lmbda: float = 0.95,
) -> torch.Tensor:
    """DreamerV1's TD(lambda) targets over `[horizon, ...]` imagination
    tensors -> `[horizon - 1, ...]`; `done_mask` is the gamma-scaled
    continuation. A reverse loop from zero: v_t = r_t + c_t ((1 - lmbda)
    V_{t+1} + lmbda v_{t+1}), V_H-1 replaced by `last_values`."""
    next_vals = torch.cat([values[1:horizon - 1] * (1.0 - lmbda), last_values[None]], dim=0)
    deltas = rewards[:horizon - 1] + next_vals * done_mask[:horizon - 1]
    carry = torch.zeros_like(last_values)
    out = [None] * (horizon - 1)
    for t in reversed(range(horizon - 1)):
        carry = deltas[t] + lmbda * done_mask[t] * carry
        out[t] = carry
    return torch.stack(out)


def lambda_values_dv2(
    rewards: torch.Tensor, values: torch.Tensor, continues: torch.Tensor, bootstrap: torch.Tensor | None = None,
    lmbda: float = 0.95,
) -> torch.Tensor:
    """DreamerV2's lambda returns over `[H, ...]` inputs with an explicit
    `bootstrap` `[1, ...]` (zeros when None); `continues` fold in gamma: a
    reverse loop from the bootstrap, v_t = r_t + c_t ((1 - lmbda)
    V_{t+1} + lmbda v_{t+1})."""
    if bootstrap is None:
        bootstrap = torch.zeros_like(values[-1:])
    next_vals = torch.cat([values[1:], bootstrap], dim=0)
    inputs = rewards + continues * next_vals * (1.0 - lmbda)
    carry = bootstrap[0]
    out = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        carry = inputs[t] + continues[t] * lmbda * carry
        out[t] = carry
    return torch.stack(out)


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
