"""DreamerV3 world-model loss (the port of
sheeprl_tpu/algos/dreamer_v3/loss.py, Eq. 4/5 of arXiv:2301.04104)."""

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
    kl_dynamic: float = 0.5,
    kl_representation: float = 0.1,
    kl_free_nats: float = 1.0,
    kl_regularizer: float = 1.0,
    pc=None,
    continue_targets: torch.Tensor | None = None,
    continue_scale_factor: float = 1.0,
):
    """KL-balanced ELBO: dynamic KL (posterior detached) * 0.5 +
    representation KL (prior detached) * 0.1, each clipped at free nats,
    plus observation/reward/continue log-likelihoods.

    Returns (loss, kl, state_loss, reward_loss, observation_loss,
    continue_loss) — scalars, means over [T, B]."""
    observation_loss = -sum(po[k].log_prob(observations[k]) for k in po)
    reward_loss = -pr.log_prob(rewards)
    kl = kl_categorical(posteriors_logits.detach(), priors_logits, event_ndims=1)
    dyn_loss = kl_dynamic * torch.clamp(kl, min=kl_free_nats)
    repr_loss = kl_categorical(posteriors_logits, priors_logits.detach(), event_ndims=1)
    repr_loss = kl_representation * torch.clamp(repr_loss, min=kl_free_nats)
    kl_loss = dyn_loss + repr_loss
    continue_loss = torch.zeros((), device=rewards.device)
    if pc is not None and continue_targets is not None:
        continue_loss = continue_scale_factor * -pc.log_prob(continue_targets)
    loss = (kl_regularizer * kl_loss + observation_loss + reward_loss + continue_loss).mean()
    return loss, kl.mean(), kl_loss.mean(), reward_loss.mean(), observation_loss.mean(), continue_loss.mean()
