"""Plan2Explore on DreamerV1 (the port of sheeprl_tpu/algos/p2e_dv1/p2e_dv1.py,
arXiv:2005.05960): `P2EDV1TrainState`, `make_optimizers`, `draw_noise`,
`make_train_step(exploring)` and `main`, which runs DreamerV2's loop
(`algos/dreamer_v2/dreamer_v2.py:run`) over the `P2E_DV1` family.

    python -m sheeprl_tpu_torch p2e_dv1 --env_id continuous_dummy --cnn_keys rgb [--device cpu]

One exploring gradient step follows the reference's `make_train_step(exploring=True)`:
DreamerV1's world-model update with the reward and continue heads fit on
detached latents (`world_update(detach_heads=True)`); the ensemble's fit
of the next embedding from (posterior, recurrent state, action)
(`ensemble_update`); the exploration behaviour on the members' variance
times `intrinsic_reward_multiplier` (`disagreement`), and the task
behaviour zero-shot on the reward model (DreamerV1's `behaviour_update`,
each with its own imagination draws). The task program
(`exploring=False`) is the world model and the task behaviour alone. Six
Adams at eps 1e-5 (the ensemble's at `ensemble_eps`), each behind the clip
(the ensemble's `ensemble_clip_gradients`) and optax's
`add_decayed_weights(1e-6)`.

The run explores until `exploration_steps // action_repeat` player steps,
plays one zero-shot episode with the task actor, then trains the task
program; the player follows the behaviour that trains. On the card each
program's gradient step and player step is one CUDA graph
("train_step_exploring", "player_step_exploring", then
"train_step_task", "player_step_task", captured at the switch). A run
resumed past the switch keeps the task program. Checkpoints hold the
reference's keys (`tests/test_algos/test_p2e.py:30-36`). No kernel runs on
this path (`agent.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ...compile.plan import CompilePlan
from ...nn.blocks import MLP, StackedMLP
from ...ops.distributions import Independent, Normal
from ...ops.optim import adam, apply_gradients
from ...ops.precision import compute_dtype
from ...utils.evaluation import parse_run_args
from ...utils.registry import register_algorithm
from ..dreamer_v1.agent import PlayerDV1
from ..dreamer_v1.dreamer_v1 import behaviour_update, imagination_noise, world_update
from ..dreamer_v2.dreamer_v2 import WEIGHT_DECAY, Family, _clip, run, wrap_train_step
from ..dreamer_v3.agent import Actor, WorldModel
from ..dreamer_v3.dreamer_v3 import _grads
from .agent import build_models, ensemble_apply
from .args import P2EDV1Args

__all__ = [
    "BEHAVIOURS", "EXPLORATION_METRICS", "METRICS_EXPLORING", "METRICS_TASK", "MOVED", "P2EDV1TrainState", "P2E_DV1",
    "TASK_METRICS", "disagreement", "draw_noise", "ensemble_update", "main", "make_optimizers", "make_train_step",
]

# the world model's metrics, then (exploring) the ensemble's and the
# exploration behaviour's, then the task behaviour's: the reference's names
WORLD_METRICS = (
    "Loss/reconstruction_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss",
    "Loss/continue_loss", "State/kl", "Grads/world_model",
)
EXPLORATION_METRICS = (
    "Loss/ensemble_loss", "Grads/ensemble", "Loss/policy_loss_exploration", "Loss/value_loss_exploration",
    "Grads/actor_exploration", "Grads/critic_exploration", "Rewards/intrinsic",
)
TASK_METRICS = ("Loss/policy_loss_task", "Loss/value_loss_task", "Grads/actor_task", "Grads/critic_task")
METRICS_EXPLORING = WORLD_METRICS + EXPLORATION_METRICS + TASK_METRICS
METRICS_TASK = WORLD_METRICS + TASK_METRICS
# the behaviours a program updates, each with its own imagination draws
BEHAVIOURS = {True: ("exploration", "task"), False: ("task",)}
# the trained modules, whose change a run reports
MOVED = ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")


@dataclasses.dataclass
class P2EDV1TrainState:
    """The models and their optimizers; a train step updates them in place."""

    world_model: WorldModel
    actor_task: Actor
    critic_task: MLP
    actor_exploration: Actor
    critic_exploration: MLP
    ensembles: StackedMLP
    world_opt: torch.optim.Optimizer
    actor_task_opt: torch.optim.Optimizer
    critic_task_opt: torch.optim.Optimizer
    actor_exploration_opt: torch.optim.Optimizer
    critic_exploration_opt: torch.optim.Optimizer
    ensemble_opt: torch.optim.Optimizer


def make_optimizers(args, world_model, actor_task, critic_task, actor_exploration, critic_exploration, ensembles):
    """Six Adams at eps 1e-5: world model, task actor and critic,
    exploration actor and critic, and the ensemble at `ensemble_lr` and
    `ensemble_eps` (the reference's `optax.adam(lr, eps)` chains; the step
    clips and decays before each)."""
    return (adam(world_model.parameters(), args.world_lr, 1e-5), adam(actor_task.parameters(), args.actor_lr, 1e-5),
            adam(critic_task.parameters(), args.critic_lr, 1e-5),
            adam(actor_exploration.parameters(), args.actor_lr, 1e-5),
            adam(critic_exploration.parameters(), args.critic_lr, 1e-5),
            adam(ensembles.parameters(), args.ensemble_lr, args.ensemble_eps))


def draw_noise(args: P2EDV1Args, seq_len: int, batch: int, actions_dim: Sequence[int], generator: torch.Generator,
               device, is_continuous: bool = False, exploring: bool = True) -> dict:
    """The draws of one gradient step: standard normals `post` [T, B, S] for
    the posteriors, then one imagination's draws for each behaviour the
    program updates (`BEHAVIOURS`; `dreamer_v1.py:imagination_noise`),
    under the behaviour's name."""
    noise = {"post": torch.randn((seq_len, batch, args.stochastic_size), generator=generator, device=device)}
    for name in BEHAVIOURS[exploring]:
        noise[name] = imagination_noise(args, seq_len * batch, actions_dim, generator, device, is_continuous)
    return noise


def ensemble_update(args, ensembles: StackedMLP, ensemble_opt, inputs: torch.Tensor, targets: torch.Tensor):
    """The ensemble's update: every member predicts step t + 1's `targets`
    from step t's `inputs` ([T, B, ...], detached) under a unit Normal; the
    loss sums the members' mean negative log-likelihoods; the Adam behind
    `ensemble_clip_gradients` and the weight decay. -> (loss, gradient
    norm)."""
    out = ensemble_apply(ensembles, inputs)[:, :-1].float()
    log_prob = Independent(Normal(out, torch.ones_like(out)), 1).log_prob(targets.float()[1:])
    loss = -log_prob.mean(dim=(1, 2)).sum()
    params = list(ensembles.parameters())
    norm = apply_gradients(params, _grads(loss, params), ensemble_opt, _clip(args.ensemble_clip_gradients),
                           WEIGHT_DECAY)
    return loss, norm


def disagreement(ensembles: StackedMLP, inputs: torch.Tensor, multiplier: float) -> torch.Tensor:
    """The intrinsic reward: the members' predictions' variance (over the
    members, population) averaged over the prediction's width, times
    `multiplier`, in f32 ([..., 1]); no gradient flows through it."""
    with torch.no_grad():
        preds = ensemble_apply(ensembles, inputs).float()
        return preds.var(dim=0, unbiased=False).mean(dim=-1, keepdim=True) * multiplier


def make_train_step(args: P2EDV1Args, cnn_keys: Sequence[str], mlp_keys: Sequence[str],
                    actions_dim: Sequence[int], is_continuous: bool, plan: CompilePlan | None = None,
                    example=None, exploring: bool = True):
    """The Plan2Explore-DV1 update (the reference's
    `make_train_step(exploring)`) -> `train_step(state, data, noise) ->
    metrics`: `data` holds [T, B, ...] tensors on the models' device
    (`rewards`, `dones`, `actions` and the observation keys, pixels as
    uint8), `noise` the draws of `draw_noise(exploring=exploring)`. The
    metrics are the reference's (`METRICS_EXPLORING`, or `METRICS_TASK` for
    the task program; `train_step.metrics`). `train_step.device_step` is
    the part on the device, registered with `plan` as
    "train_step_exploring" or "train_step_task" when a plan is given; it
    returns the metrics as one f32 tensor."""
    dt = compute_dtype(args.precision)

    def device_step(state: P2EDV1TrainState, data: dict, noise: dict) -> torch.Tensor:
        wm = state.world_model
        losses, wm_norm, recurrent_states, posteriors, _, _, embedded = world_update(
            args, wm, state.world_opt, data, noise, cnn_keys, mlp_keys, detach_heads=True,
            weight_decay=WEIGHT_DECAY)
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        out = [rec_loss, observation_loss, reward_loss, state_loss, continue_loss, kl, wm_norm]
        if exploring:
            # time-major rows: step t's (posterior, recurrent state, action
            # that led to it) against step t + 1's embedding
            inputs = torch.cat([posteriors, recurrent_states, data["actions"].to(dt)], dim=-1)
            out += ensemble_update(args, state.ensembles, state.ensemble_opt, inputs, embedded)

            def intrinsic(trajectories, actions):
                return disagreement(state.ensembles, torch.cat([trajectories.detach(), actions.detach()], dim=-1),
                                    args.intrinsic_reward_multiplier)

            policy_loss, actor_norm, value_loss, critic_norm, rewards = behaviour_update(
                args, wm, state.actor_exploration, state.critic_exploration, state.actor_exploration_opt,
                state.critic_exploration_opt, recurrent_states, posteriors, noise["exploration"], is_continuous,
                reward_fn=intrinsic, weight_decay=WEIGHT_DECAY)
            out += [policy_loss, value_loss, actor_norm, critic_norm, rewards]
        policy_loss, actor_norm, value_loss, critic_norm, _ = behaviour_update(
            args, wm, state.actor_task, state.critic_task, state.actor_task_opt, state.critic_task_opt,
            recurrent_states, posteriors, noise["task"], is_continuous, weight_decay=WEIGHT_DECAY)
        out += [policy_loss, value_loss, actor_norm, critic_norm]
        return torch.stack(out).detach().float()

    name = "train_step_exploring" if exploring else "train_step_task"
    metrics = METRICS_EXPLORING if exploring else METRICS_TASK
    return wrap_train_step(device_step, metrics, plan, name, example, tau=False)


P2E_DV1 = Family("p2e_dv1", build_models, P2EDV1TrainState, make_optimizers, PlayerDV1, make_train_step,
                 draw_noise, ("rewards", "dones"), target_critic=False, actor="actor_task",
                 explore_actor="actor_exploration", moved=MOVED)


@register_algorithm()
def main(argv: Sequence[str] | None = None) -> None:
    run(parse_run_args(P2EDV1Args, argv), P2E_DV1)
