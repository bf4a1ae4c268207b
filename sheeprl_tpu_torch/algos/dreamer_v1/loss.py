"""DreamerV1's losses (the port of sheeprl_tpu/algos/dreamer_v1/loss.py;
Eq. 7, 8 and 10 of arXiv:1912.01603)."""

from __future__ import annotations

import torch

from ...ops.distributions import Normal, kl_normal

__all__ = ["actor_loss", "critic_loss", "reconstruction_loss"]


def actor_loss(discounted_lambda_values: torch.Tensor) -> torch.Tensor:
    """Eq. 7: maximize the discounted lambda returns."""
    return -discounted_lambda_values.mean()


def critic_loss(qv, lambda_values: torch.Tensor, discount: torch.Tensor) -> torch.Tensor:
    """Eq. 8: the discounted negative log-likelihood of the lambda returns."""
    return -(discount * qv.log_prob(lambda_values)).mean()


def reconstruction_loss(
    qo: dict,
    observations: dict,
    qr,
    rewards: torch.Tensor,
    posterior_mean_std: tuple[torch.Tensor, torch.Tensor],
    prior_mean_std: tuple[torch.Tensor, torch.Tensor],
    kl_free_nats: float = 3.0,
    kl_regularizer: float = 1.0,
    qc=None,
    continue_targets: torch.Tensor | None = None,
    continue_scale_factor: float = 10.0,
):
    """Eq. 10: the Gaussian KL(posterior || prior), averaged and held at
    least `kl_free_nats`, plus the Normal(x, 1) observation and reward
    log-likelihoods and, with a continue head, its Bernoulli's (a negative
    log-likelihood, as in the reference). -> (loss, kl, state_loss,
    reward_loss, observation_loss, continue_loss), scalars."""
    observation_loss = -sum(qo[k].log_prob(observations[k]).mean() for k in qo)
    reward_loss = -qr.log_prob(rewards).mean()
    kl = kl_normal(Normal(*posterior_mean_std), Normal(*prior_mean_std), event_ndims=1).mean()
    state_loss = torch.clamp_min(kl, kl_free_nats)
    continue_loss = torch.zeros((), device=kl.device)
    if qc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -qc.log_prob(continue_targets).mean()
    loss = kl_regularizer * state_loss + observation_loss + reward_loss + continue_loss
    return loss, kl, state_loss, reward_loss, observation_loss, continue_loss
