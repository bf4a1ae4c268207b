"""SAC losses (the port of sheeprl_tpu/algos/sac/loss.py), per "Soft
Actor-Critic Algorithms and Applications" (https://arxiv.org/abs/1812.05905)."""

from __future__ import annotations

import torch

__all__ = ["critic_loss", "entropy_loss", "policy_loss"]


def policy_loss(alpha: torch.Tensor, logprobs: torch.Tensor, qf_values: torch.Tensor) -> torch.Tensor:
    """Eq. 7: E[alpha * log pi(a|s) - Q(s, a)]."""
    return (alpha * logprobs - qf_values).mean()


def critic_loss(qf_values: torch.Tensor, next_qf_value: torch.Tensor) -> torch.Tensor:
    """Eq. 5 summed over the ensemble: sum_i MSE(Q_i(s, a), y). `qf_values`
    is `[..., n]`; the target broadcasts over the ensemble axis."""
    return (qf_values - next_qf_value).square().mean(dim=tuple(range(qf_values.dim() - 1))).sum()


def entropy_loss(log_alpha: torch.Tensor, logprobs: torch.Tensor, target_entropy: float) -> torch.Tensor:
    """Eq. 17: E[-log_alpha * (log pi(a|s) + target_entropy)], the
    log-probs detached."""
    return (-log_alpha * (logprobs.detach() + target_entropy)).mean()
