"""DreamerV2's world-model loss (the port of
sheeprl_tpu/algos/dreamer_v2/loss.py; Eq. 2 of arXiv:2010.02193) with
alpha-KL balancing."""

from __future__ import annotations

import torch

from ...ops.distributions import kl_categorical

__all__ = ["reconstruction_loss"]


def reconstruction_loss(
    po: dict,
    observations: dict,
    pr,
    rewards: torch.Tensor,
    priors_logits: torch.Tensor,  # [T, B, S, D]
    posteriors_logits: torch.Tensor,  # [T, B, S, D]
    kl_balancing_alpha: float = 0.8,
    kl_free_nats: float = 0.0,
    kl_free_avg: bool = True,
    kl_regularizer: float = 1.0,
    pc=None,
    continue_targets: torch.Tensor | None = None,
    continue_scale_factor: float = 1.0,
):
    """alpha KL(sg(post) || prior) + (1 - alpha) KL(post || sg(prior)), each
    held at least `kl_free_nats` (on its mean when `kl_free_avg`, else
    elementwise), plus the Normal(x, 1) observation and reward
    log-likelihoods and the continue Bernoulli's.
    -> (loss, kl [T, B], kl_loss, reward_loss, observation_loss,
    continue_loss)."""
    observation_loss = -sum(po[k].log_prob(observations[k]).mean() for k in po)
    reward_loss = -pr.log_prob(rewards).mean()
    lhs = kl = kl_categorical(posteriors_logits.detach(), priors_logits, event_ndims=1)
    rhs = kl_categorical(posteriors_logits, priors_logits.detach(), event_ndims=1)
    free_nats = torch.full((), float(kl_free_nats), device=lhs.device)
    if kl_free_avg:
        loss_lhs, loss_rhs = torch.maximum(lhs.mean(), free_nats), torch.maximum(rhs.mean(), free_nats)
    else:
        loss_lhs, loss_rhs = torch.maximum(lhs, free_nats).mean(), torch.maximum(rhs, free_nats).mean()
    kl_loss = kl_balancing_alpha * loss_lhs + (1 - kl_balancing_alpha) * loss_rhs
    continue_loss = torch.zeros((), device=lhs.device)
    if pc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -pc.log_prob(continue_targets).mean()
    loss = kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss
    return loss, kl, kl_loss, reward_loss, observation_loss, continue_loss
