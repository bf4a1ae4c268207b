"""DreamerV1 training (the port of sheeprl_tpu/algos/dreamer_v1/dreamer_v1.py):
`make_optimizers`, `draw_noise`, `make_train_step` and `main`, which runs
DreamerV2's synchronous loop (`algos/dreamer_v2/dreamer_v2.py:run`) with
V1's pieces.

    python -m sheeprl_tpu_torch dreamer_v1 --env_id continuous_dummy --cnn_keys rgb [--device cpu]
    python -m sheeprl_tpu_torch dreamer_v1 --env_id Pendulum-v1 --mlp_keys state --no_use_continues

One gradient step follows the reference's `make_train_step`: the world
model's update (the Gaussian RSSM over the sequence, Normal(x, 1)
observation and reward likelihoods, the continue Bernoulli with
`--use_continues`, the Gaussian KL held at `kl_free_nats`, `loss.py`),
imagination over `horizon` steps with the updated world model, the actor's
update on the discounted lambda returns (pure dynamics backpropagation
through the imagined trajectory; no target critic, no entropy bonus), and
the critic's. Three Adams (eps 1e-8) behind optax's
`clip_by_global_norm(clip_gradients)`, written by hand. Every draw is
given (`draw_noise`: standard normals for the Gaussian states, uniforms or
Gumbels for the actor); on the card the step is one CUDA graph
("train_step") and so is the player's (`PlayerDV1.noisy_step`, whose
exploration amount is a device scalar decaying with `--expl_decay`). The
replay rows are V2's without `is_first`, in `AsyncReplayBuffer` rings. No
kernel runs on this path (`agent.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ...compile.decisions import remat_mode
from ...compile.plan import CompilePlan
from ...nn.blocks import MLP
from ...ops.distributions import Bernoulli, Independent, Normal, gumbel_noise
from ...ops.math import lambda_values
from ...ops.optim import adam, apply_gradients
from ...ops.precision import compute_dtype, to_compute, to_float32
from ...ops.scan import checkpoint_body
from ...utils.evaluation import parse_run_args
from ...utils.registry import register_algorithm
from ..dreamer_v2.dreamer_v2 import Family, _clip, run, wrap_train_step
from ..dreamer_v3.agent import Actor, WorldModel
from ..dreamer_v3.dreamer_v3 import METRICS, _grads
from .agent import PlayerDV1, build_models
from .args import DreamerV1Args
from .loss import actor_loss, critic_loss, reconstruction_loss

__all__ = ["DREAMER_V1", "DV1TrainState", "behaviour_update", "draw_noise", "imagination_noise", "main",
           "make_optimizers", "make_train_step", "world_update"]


@dataclasses.dataclass
class DV1TrainState:
    """The models and their optimizers; a train step updates them in place."""

    world_model: WorldModel
    actor: Actor
    critic: MLP
    world_opt: torch.optim.Optimizer
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer


def make_optimizers(args: DreamerV1Args, world_model, actor, critic):
    """Three Adams at optax's default eps 1e-8; the step clips before each."""
    return (adam(world_model.parameters(), args.world_lr, 1e-8), adam(actor.parameters(), args.actor_lr, 1e-8),
            adam(critic.parameters(), args.critic_lr, 1e-8))


def draw_noise(args: DreamerV1Args, seq_len: int, batch: int, actions_dim: Sequence[int],
               generator: torch.Generator, device, is_continuous: bool = False) -> dict:
    """The draws of one gradient step: standard normals `post` [T, B, S] for
    the posteriors, then imagination's (`imagination_noise`)."""
    noise = {"post": torch.randn((seq_len, batch, args.stochastic_size), generator=generator, device=device)}
    noise.update(imagination_noise(args, seq_len * batch, actions_dim, generator, device, is_continuous))
    return noise


def imagination_noise(args, n: int, actions_dim: Sequence[int], generator: torch.Generator, device,
                      is_continuous: bool) -> dict:
    """One imagination's draws from `n` starts: standard normals
    `img_prior` [H, n, S] for the imagined priors, and `img_actions` for
    the imagined actions: one [H, n, A] tensor of uniform floats for the
    tanh-normal actor, or Gumbels [H, n, A_i] a discrete head."""
    s, h = args.stochastic_size, args.horizon
    noise = {"img_prior": torch.randn((h, n, s), generator=generator, device=device)}
    if is_continuous:
        noise["img_actions"] = torch.rand((h, n, int(sum(actions_dim))), generator=generator, device=device)
    else:
        noise["img_actions"] = [gumbel_noise((h, n, a), generator, device) for a in actions_dim]
    return noise


def world_update(args, world_model: WorldModel, world_opt, data: dict, noise: dict, cnn_keys: Sequence[str],
                 mlp_keys: Sequence[str], detach_heads: bool = False, weight_decay: float = 0.0):
    """The world model's update of one gradient step (the Gaussian RSSM
    over the sequence with `noise["post"]`, Normal(x, 1) likelihoods, the
    continue Bernoulli, the KL held at `kl_free_nats`, then the Adam behind
    the clip and `weight_decay`); with `detach_heads` (Plan2Explore) the
    reward and continue heads fit on detached latents. -> (the losses, the
    gradient norm, and detached: the recurrent states, posteriors, their
    and the priors' entropies, the embedded observations)."""
    dt = compute_dtype(args.precision)
    remat = remat_mode(getattr(args, "remat", "off"))
    wm = world_model
    T, B = data["dones"].shape[:2]
    obs_targets = {k: data[k].float() / 255.0 - 0.5 for k in cnn_keys}
    obs_targets.update({k: data[k].float() for k in mlp_keys})
    embedded = wm.encoder(to_compute(obs_targets, dt))
    posterior0 = embedded.new_zeros((B, args.stochastic_size), dtype=dt)
    recurrent0 = embedded.new_zeros((B, args.recurrent_state_size), dtype=dt)
    recurrent_states, posteriors, post_means, post_stds, prior_means, prior_stds = wm.rssm.scan_dynamic(
        posterior0, recurrent0, data["actions"].to(dt), embedded, noise["post"], remat=remat
    )
    latent_states = torch.cat([posteriors, recurrent_states], dim=-1)
    heads_in = latent_states.detach() if detach_heads else latent_states
    decoded = to_float32(wm.observation_model(latent_states))
    qo = {k: Independent(Normal(v, torch.ones_like(v)), v.dim() - 2) for k, v in decoded.items()}
    reward_mean = to_float32(wm.reward_model(heads_in))
    qr = Independent(Normal(reward_mean, torch.ones_like(reward_mean)), 1)
    qc = continue_targets = None
    if args.use_continues:
        qc = Independent(Bernoulli(to_float32(wm.continue_model(heads_in))), 1)
        continue_targets = (1.0 - data["dones"]) * args.gamma
    losses = reconstruction_loss(
        qo, obs_targets, qr, data["rewards"], (post_means, post_stds), (prior_means, prior_stds),
        args.kl_free_nats, args.kl_regularizer, qc, continue_targets, args.continue_scale_factor,
    )
    params = list(wm.parameters())
    norm = apply_gradients(params, _grads(losses[0], params), world_opt, _clip(args.clip_gradients), weight_decay)
    with torch.no_grad():
        post_entropy = Independent(Normal(post_means, post_stds), 1).entropy().mean()
        prior_entropy = Independent(Normal(prior_means, prior_stds), 1).entropy().mean()
    return (losses, norm, recurrent_states.detach(), posteriors.detach(), post_entropy, prior_entropy,
            embedded.detach())


def behaviour_update(args, world_model: WorldModel, actor: Actor, critic: MLP, actor_opt, critic_opt,
                     recurrent_states, posteriors, noise: dict, is_continuous: bool,
                     reward_fn: Callable | None = None, weight_decay: float = 0.0):
    """One behaviour's update: imagination over `horizon` steps from every
    posterior with the (updated) world model and `noise`'s draws
    (`img_prior`, `img_actions`), the discounted lambda returns of
    `reward_fn(trajectories, actions)` ([H, T*B, 1] f32 over the post-step
    latents and the actions that reached them; the reward model's by
    default), the actor's loss through the imagined trajectory (the world
    model and critic its constants), then the critic's; each Adam behind
    the clip and `weight_decay`. -> (policy loss, actor gradient norm,
    value loss, critic gradient norm, the imagined rewards' mean)."""
    remat = remat_mode(getattr(args, "remat", "off"))
    horizon = args.horizon
    clip = _clip(args.clip_gradients)
    wm = world_model
    T, B = recurrent_states.shape[:2]
    if reward_fn is None:
        def reward_fn(trajectories, _actions):
            return to_float32(wm.reward_model(trajectories))

    frozen = (wm, critic)
    for m in frozen:
        m.requires_grad_(False)
    try:
        prior = posteriors.transpose(0, 1).reshape(T * B, args.stochastic_size)
        recurrent = recurrent_states.transpose(0, 1).reshape(T * B, args.recurrent_state_size)

        def img_step(prior, recurrent, draws: dict, normal):
            latent = torch.cat([prior, recurrent], dim=-1)
            acts, _ = actor(latent.detach(), **draws)
            action = torch.cat(acts, dim=-1).to(prior.dtype)
            prior, recurrent = wm.rssm.imagination(prior, recurrent, action, normal)
            return prior, recurrent, action

        img_step = checkpoint_body(img_step, remat)
        latents, actions = [], []
        for h in range(horizon):
            draws = ({"uniforms": noise["img_actions"][h]} if is_continuous
                     else {"gumbels": [g[h] for g in noise["img_actions"]]})
            prior, recurrent, action = img_step(prior, recurrent, draws, noise["img_prior"][h])
            latents.append(torch.cat([prior, recurrent], dim=-1))
            actions.append(action)
        # the post-step latents: no entry for the start
        trajectories = torch.stack(latents)  # [H, T*B, L]
        predicted_values = to_float32(critic(trajectories))
        predicted_rewards = reward_fn(trajectories, torch.stack(actions)).float()
        if args.use_continues:
            continues = Independent(Bernoulli(to_float32(wm.continue_model(trajectories))), 1).mean
        else:
            continues = torch.ones_like(predicted_rewards.detach()) * args.gamma
        lambdas = lambda_values(predicted_rewards, predicted_values, continues, predicted_values[-1],
                                horizon=horizon, lmbda=args.lmbda)  # [H-1, T*B, 1]
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-2]], dim=0), dim=0).detach()
        policy_loss = actor_loss(discount * lambdas)
        params = list(actor.parameters())
        actor_norm = apply_gradients(params, _grads(policy_loss, params), actor_opt, clip, weight_decay)
    finally:
        for m in frozen:
            m.requires_grad_(True)

    value_mean = to_float32(critic(trajectories.detach()))[:-1]
    qv = Independent(Normal(value_mean, torch.ones_like(value_mean)), 1)
    value_loss = critic_loss(qv, lambdas.detach(), discount[..., 0])
    params = list(critic.parameters())
    critic_norm = apply_gradients(params, _grads(value_loss, params), critic_opt, clip, weight_decay)
    return policy_loss, actor_norm, value_loss, critic_norm, predicted_rewards.detach().mean()


def make_train_step(args: DreamerV1Args, cnn_keys: Sequence[str], mlp_keys: Sequence[str],
                    actions_dim: Sequence[int], is_continuous: bool, plan: CompilePlan | None = None,
                    example=None):
    """The DreamerV1 update (the reference's `make_train_step`) ->
    `train_step(state, data, noise) -> metrics`: `data` holds [T, B, ...]
    tensors on the models' device (`rewards`, `dones`, `actions` and the
    observation keys, pixels as uint8), `noise` the draws of `draw_noise`.
    The metrics are the reference's 13. `train_step.device_step(state,
    data, noise)` is the part on the device, registered with `plan` as
    "train_step" when a plan is given; it returns them as one f32 tensor."""

    def device_step(state: DV1TrainState, data: dict, noise: dict) -> torch.Tensor:
        losses, wm_norm, recurrent_states, posteriors, post_entropy, prior_entropy, _ = world_update(
            args, state.world_model, state.world_opt, data, noise, cnn_keys, mlp_keys)
        policy_loss, actor_norm, value_loss, critic_norm, _ = behaviour_update(
            args, state.world_model, state.actor, state.critic, state.actor_opt, state.critic_opt,
            recurrent_states, posteriors, noise, is_continuous)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        return torch.stack([
            rec_loss, observation_loss, reward_loss, state_loss, continue_loss, policy_loss, value_loss,
            kl, post_entropy, prior_entropy, wm_norm, actor_norm, critic_norm,
        ]).detach().float()

    return wrap_train_step(device_step, METRICS, plan, "train_step", example, tau=False)


DREAMER_V1 = Family("dreamer_v1", build_models, DV1TrainState, make_optimizers, PlayerDV1, make_train_step,
                    draw_noise, ("rewards", "dones"), target_critic=False)


@register_algorithm()
def main(argv: Sequence[str] | None = None) -> None:
    run(parse_run_args(DreamerV1Args, argv), DREAMER_V1)
