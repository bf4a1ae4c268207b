"""Plan2Explore on DreamerV2 (the port of sheeprl_tpu/algos/p2e_dv2/p2e_dv2.py):
`P2EDV2TrainState`, `make_optimizers`, `draw_noise`,
`make_train_step(exploring)` and `main`, which runs DreamerV2's loop
(`algos/dreamer_v2/dreamer_v2.py:run`) over the `P2E_DV2` family.

    python -m sheeprl_tpu_torch p2e_dv2 --env_id discrete_dummy --cnn_keys rgb [--device cpu]

One exploring gradient step follows the reference's
`make_train_step(exploring=True)`: both target critics copied under one
device-scalar `tau`; DreamerV2's world-model update with the reward and
continue heads fit on detached latents; the ensemble's fit of the next
posterior (S * D wide) from (posterior, recurrent state, action), in
f32, its rows time-major so that they line up with `data["actions"]` and
the `[1:]` targets; the exploration behaviour on the members' variance
times `intrinsic_reward_multiplier`, computed in f32 end to end (also
under `--precision bfloat16`); the task behaviour zero-shot on the reward
model. Each behaviour is DreamerV2's `behaviour_update` with its own
imagination draws, its actor's objective REINFORCE for discrete actions
and dynamics backpropagation for continuous ones (the reference's P2E
behaviour; `objective_mix` is DreamerV2's alone). `--remat` covers both
imaginations. The task program (`exploring=False`) is the world model and
the task behaviour alone. Six Adams as `algos/p2e_dv1/p2e_dv1.py`'s.

The loop, the switch at `exploration_steps // action_repeat`, the graphs
and the checkpoints are P2E-DV1's (that module's docstring), with
DreamerV2's replay rows (`is_first`), pretraining and `--buffer_type
episode`. No kernel runs on this path (`agent.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ...compile.plan import CompilePlan
from ...nn.blocks import MLP, StackedMLP
from ...ops.distributions import gumbel_noise
from ...utils.evaluation import parse_run_args
from ...utils.registry import register_algorithm
from ..dreamer_v2.agent import PlayerDV2
from ..dreamer_v2.dreamer_v2 import (
    ROW_KEYS, Family, behaviour_update, hard_copy, latent_entropies, run, world_update, wrap_train_step,
)
from ..dreamer_v3.agent import Actor, WorldModel
from ..p2e_dv1.p2e_dv1 import BEHAVIOURS, EXPLORATION_METRICS, MOVED, TASK_METRICS, disagreement, ensemble_update
from ..p2e_dv1.p2e_dv1 import make_optimizers as _six_adams
from .agent import build_models
from .args import P2EDV2Args

__all__ = [
    "METRICS_EXPLORING", "METRICS_TASK", "P2EDV2TrainState", "P2E_DV2", "draw_noise", "main", "make_optimizers",
    "make_train_step",
]

WORLD_METRICS = (
    "Loss/reconstruction_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss",
    "Loss/continue_loss", "State/kl", "State/post_entropy", "State/prior_entropy", "Grads/world_model",
)
METRICS_EXPLORING = WORLD_METRICS + EXPLORATION_METRICS + TASK_METRICS
METRICS_TASK = WORLD_METRICS + TASK_METRICS


@dataclasses.dataclass
class P2EDV2TrainState:
    """The models and their optimizers; a train step updates them in place."""

    world_model: WorldModel
    actor_task: Actor
    critic_task: MLP
    target_critic_task: MLP
    actor_exploration: Actor
    critic_exploration: MLP
    target_critic_exploration: MLP
    ensembles: StackedMLP
    world_opt: torch.optim.Optimizer
    actor_task_opt: torch.optim.Optimizer
    critic_task_opt: torch.optim.Optimizer
    actor_exploration_opt: torch.optim.Optimizer
    critic_exploration_opt: torch.optim.Optimizer
    ensemble_opt: torch.optim.Optimizer


def make_optimizers(args, world_model, actor_task, critic_task, target_critic_task, actor_exploration,
                    critic_exploration, target_critic_exploration, ensembles):
    """P2E-DV1's six Adams; the target critics take none."""
    return _six_adams(args, world_model, actor_task, critic_task, actor_exploration, critic_exploration, ensembles)


def draw_noise(args: P2EDV2Args, seq_len: int, batch: int, actions_dim: Sequence[int], generator: torch.Generator,
               device, is_continuous: bool = False, exploring: bool = True) -> dict:
    """The draws of one gradient step: the Gumbels `post` [T, B, S, D] for
    the posteriors, then for each behaviour the program updates
    (`BEHAVIOURS`), under its name, `img_prior` [H, T*B, S, D] and
    `img_actions` (Gumbels [H, T*B, A_i] a discrete head, or one [H, T*B, A]
    tensor of uniform floats for a continuous actor)."""
    s, d, h, n = args.stochastic_size, args.discrete_size, args.horizon, seq_len * batch
    noise = {"post": gumbel_noise((seq_len, batch, s, d), generator, device)}
    for name in BEHAVIOURS[exploring]:
        draws = {"img_prior": gumbel_noise((h, n, s, d), generator, device)}
        if is_continuous:
            draws["img_actions"] = torch.rand((h, n, int(sum(actions_dim))), generator=generator, device=device)
        else:
            draws["img_actions"] = [gumbel_noise((h, n, a), generator, device) for a in actions_dim]
        noise[name] = draws
    return noise


def make_train_step(args: P2EDV2Args, cnn_keys: Sequence[str], mlp_keys: Sequence[str],
                    actions_dim: Sequence[int], is_continuous: bool, plan: CompilePlan | None = None,
                    example=None, exploring: bool = True):
    """The Plan2Explore-DV2 update (the reference's
    `make_train_step(exploring)`) -> `train_step(state, data, tau, noise)
    -> metrics`: `data` as DreamerV2's (with `is_first`), `tau` the weight
    of both hard target-critic copies (1 copies, 0 keeps), `noise` the draws
    of `draw_noise(exploring=exploring)`. The metrics are the reference's
    (`METRICS_EXPLORING` or `METRICS_TASK`; `train_step.metrics`).
    `train_step.device_step(state, data, tau, noise)` is the part on the
    device, `tau` a device scalar, registered with `plan` as
    "train_step_exploring" or "train_step_task" when a plan is given."""
    objective = "dynamics" if is_continuous else "reinforce"

    def device_step(state: P2EDV2TrainState, data: dict, tau: torch.Tensor, noise: dict) -> torch.Tensor:
        hard_copy(state.target_critic_task, state.critic_task, tau)
        hard_copy(state.target_critic_exploration, state.critic_exploration, tau)
        wm = state.world_model
        T, B = data["dones"].shape[:2]
        losses, wm_norm, recurrent_states, posteriors, priors_logits, posteriors_logits = world_update(
            args, wm, state.world_opt, data, noise, cnn_keys, mlp_keys, detach_heads=True)
        post_entropy, prior_entropy = latent_entropies(args, priors_logits, posteriors_logits, T, B)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        out = [rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl.mean(), post_entropy,
               prior_entropy, wm_norm]
        if exploring:
            # time-major rows, in f32: step t's (posterior, recurrent state,
            # action that led to it) against step t + 1's posterior
            posteriors_flat = posteriors.reshape(T, B, -1).float()
            inputs = torch.cat([posteriors_flat, recurrent_states.float(), data["actions"].float()], dim=-1)
            out += ensemble_update(args, state.ensembles, state.ensemble_opt, inputs, posteriors_flat)

            def intrinsic(trajectories, actions):
                return disagreement(state.ensembles, torch.cat([trajectories, actions], dim=-1).detach().float(),
                                    args.intrinsic_reward_multiplier)

            policy_loss, actor_norm, value_loss, critic_norm, rewards = behaviour_update(
                args, wm, state.actor_exploration, state.critic_exploration, state.target_critic_exploration,
                state.actor_exploration_opt, state.critic_exploration_opt, data, recurrent_states, posteriors,
                noise["exploration"], is_continuous, actions_dim, reward_fn=intrinsic, objective=objective)
            out += [policy_loss, value_loss, actor_norm, critic_norm, rewards]
        policy_loss, actor_norm, value_loss, critic_norm, _ = behaviour_update(
            args, wm, state.actor_task, state.critic_task, state.target_critic_task, state.actor_task_opt,
            state.critic_task_opt, data, recurrent_states, posteriors, noise["task"], is_continuous, actions_dim,
            objective=objective)
        out += [policy_loss, value_loss, actor_norm, critic_norm]
        return torch.stack(out).detach().float()

    name = "train_step_exploring" if exploring else "train_step_task"
    metrics = METRICS_EXPLORING if exploring else METRICS_TASK
    return wrap_train_step(device_step, metrics, plan, name, example, tau=True)


P2E_DV2 = Family("p2e_dv2", build_models, P2EDV2TrainState, make_optimizers, PlayerDV2, make_train_step,
                 draw_noise, ROW_KEYS, target_critic=True, actor="actor_task", explore_actor="actor_exploration",
                 moved=MOVED)


@register_algorithm()
def main(argv: Sequence[str] | None = None) -> None:
    run(parse_run_args(P2EDV2Args, argv), P2E_DV2)
