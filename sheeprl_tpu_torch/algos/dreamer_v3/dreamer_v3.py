"""DreamerV3 training (the port of sheeprl_tpu/algos/dreamer_v3/dreamer_v3.py):
`make_optimizers`, `make_train_step` and a synchronous `main` over
`num_envs` host envs, or (`--env_backend jax`) the batched envs on the
device.

    python -m sheeprl_tpu_torch dreamer_v3 --env_id discrete_dummy [--device cpu]
    python -m sheeprl_tpu_torch dreamer_v3 --env_id pixeltoy --env_backend jax --num_envs 16
    python -m sheeprl_tpu_torch dreamer_v3 --env_id pixeltoy --grayscale_obs --num_envs 4 --action_repeat 2 \
        --max_episode_steps 100 --remat on --profile --profile_steps 2

The host envs are `utils/env.py:make_dict_env`'s chain (each action
repeated `--action_repeat` times, 4 by default as in the reference;
episodes cut at `--max_episode_steps // action_repeat`; images resized,
grayed and stacked as asked) in `envs/vector.py`'s vector env: one worker
process an env unless `--sync_env` or one env, as in the reference. Their
rows go into a replay ring on the device, or with `--memmap_buffer` into
host memmap files under `<run_dir>/memmap_buffer`. `--remat on|policy`
checkpoints the RSSM scan's and imagination's steps
(`ops/scan.py:checkpoint_body`); `auto` is settled by
`algos/dreamer_v2/utils.py:maybe_decide_remat` before the first step.
Each gradient step's metrics stay on the device until the log pulls them
(`utils/metric.py`, one copy); `telemetry.jsonl` gets the phase times
(`telemetry/core.py`), and `--profile` a torch.profiler window over
`--profile_steps` gradient steps (`utils/profiler.py`).

One gradient step follows the reference's `make_train_step`: the EMA
target-critic update first (tau 1 at the first gradient step), the world
model's update (RSSM dynamic learning as a loop over T), imagination and
the actor's update with the updated world model and the pre-update critic,
then the critic's update; three Adams with gradient clipping by global norm
written to optax's rule. Every sample draws injected Gumbel noise (the
parity tests feed the reference's own draws) or noise from a
`torch.Generator`. `--precision bfloat16` follows the mixed-precision
policy of `ops/precision.py`: the forwards and backwards run in bf16, the
parameters, Adam moments, heads' logits and losses in f32.

Checkpoints (`utils/checkpoint.py`): `--checkpoint_every N` writes
`<run_dir>/checkpoints/ckpt_<step>` every N policy steps, and always at
`--dry_run` and at the last step, under the reference's key contract
(`checkpoint_state`); `--checkpoint_buffer` adds the replay buffer as
`ckpt_<step>_buffer.npz`. `--checkpoint_path` resumes: the config comes
from the checkpoint's sidecar (the path kept), the run directory is the
checkpoint's, the state is restored (`restore_state`), the loop starts at
`global_step + 1`, `learning_starts` moves past it when no buffer was
saved, the exploration decay is recomputed, and a saved buffer is loaded.
Flags given on the command line override the sidecar
(`utils/evaluation.py:apply_eval_overrides`): `--total_steps 2N` trains on
to the new budget. As in the reference, the gradient-step counter restarts
at 0, so the first gradient step after a resume copies the critic into the
target (tau 1).

Evaluation: every run ends with `--test_episodes` episodes in fresh envs
(`utils.py:test`, the actor's samples, seeds `seed + i`);
`--eval_only --checkpoint_path P` loads P (not its buffer) and runs only
those, logging where its own `--root_dir` says or in P's run directory.

`--env_backend jax` (the reference's Anakin path, `dreamer_v3.py:869-915`,
`:1031-1085`): the envs are `envs/device/`'s batched twin of `--env_id`
(an id without one raises) and collection is chunked at the training
cadence, `anakin_chunk = max(min(train_every // num_envs, num_updates -
start_step + 1), 1)` steps of every env a chunk, each chunk one call of
`envs/device/rollout.py:make_dreamer_collector` registered with the plan
as "anakin_rollout" ("anakin_rollout_random" in the learning-starts
warm-up): on the card one CUDA graph replay, the player's steps inside it.
The rows go into a replay ring on the device (`AsyncReplayBuffer`,
`storage="device"`) by `reserve` and `add_direct`, and the ring's samples
stay there. `global_step` steps by the chunk and names its last step (a
trailing partial chunk is dropped, as in the reference); the first chunk
that reaches `learning_starts` takes the pretrain steps. The env carry,
the player's state and the draws (one for a chunk's reset states, one for
its uniforms or its random actions) live on the device; the episode dict
is pulled once a chunk. A checkpoint is also written at the loop's last
chunk. The carry is not checkpointed (nor is it in the reference): a
resume starts from fresh envs.

Continuous actions (a Box action space: `continuous_dummy`, Pendulum-v1,
on either env backend) train the truncated-normal actor (`--actor_distribution
auto`) through imagination (`make_train_step`); the warm-up draws the
box's own samples, the ring stores the float actions and the envs take
them as they are. The gymnasium env backends are not ported. The device
envs repeat no action, as the reference's `VecJaxEnv` path does; the test
episodes at the end of such a run do.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Sequence

import numpy as np
import torch

from ...compile.decisions import remat_mode
from ...compile.plan import CompilePlan
from ...data.buffers import AsyncReplayBuffer
from ...envs.device import VecDeviceEnv, make_device_env
from ...envs.device.rollout import DreamerCollectorCarry, make_dreamer_collector, random_action_sampler
from ...nn.blocks import MLP
from ...ops.distributions import (
    Bernoulli,
    Independent,
    MSEDistribution,
    OneHotCategorical,
    SymlogDistribution,
    TanhNormal,
    TwoHotEncodingDistribution,
    gumbel_noise,
)
from ...ops.math import lambda_values_dv3, polynomial_decay
from ...ops.moments import Moments
from ...ops.optim import adam, apply_gradients, clip_by_global_norm, global_norm, load_optimizer_state
from ...ops.precision import compute_dtype, to_compute, to_float32
from ...ops.scan import checkpoint_body
from ...envs.vector import make_vector_env
from ...telemetry.core import Telemetry
from ...utils.checkpoint import load_checkpoint, save_checkpoint
from ...utils.device import check_num_devices, resolve_device
from ...utils.env import make_dict_env, obs_zeros
from ...utils.evaluation import parse_run_args, run_test_episodes
from ...utils.logger import create_logger
from ...utils.metric import MetricAggregator
from ...utils.profiler import StepProfiler
from ...parallel.anakin import AnakinStats
from ...utils.registry import register_algorithm
from ..dreamer_v2.utils import maybe_decide_remat
from ..ppo.ppo import actions_dim_of, validate_obs_keys
from .agent import Actor, PlayerDV3, WorldModel, build_models
from .args import DreamerV3Args
from .loss import reconstruction_loss
from .utils import make_device_preprocess, test

__all__ = [
    "DV3TrainState", "checkpoint_state", "clip_by_global_norm", "draw_noise", "global_norm", "main",
    "make_optimizers", "make_train_step", "restore_state",
]

METRICS = (
    "Loss/reconstruction_loss", "Loss/observation_loss", "Loss/reward_loss", "Loss/state_loss",
    "Loss/continue_loss", "Loss/policy_loss", "Loss/value_loss", "State/kl", "State/post_entropy",
    "State/prior_entropy", "Grads/world_model", "Grads/actor", "Grads/critic",
)


@dataclasses.dataclass
class DV3TrainState:
    """The models, their optimizers and the return normalizer; a train
    step updates them in place."""

    world_model: WorldModel
    actor: Actor
    critic: MLP
    target_critic: MLP
    world_opt: torch.optim.Optimizer
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    moments: Moments


def checkpoint_state(state: DV3TrainState, expl_decay_steps: int, global_step: int, batch_size: int) -> dict:
    """What a checkpoint holds, under the reference's key contract
    (`dreamer_v3.py:1301-1313`); `save_checkpoint` copies it to the host."""
    return {
        "world_model": state.world_model.state_dict(), "actor": state.actor.state_dict(),
        "critic": state.critic.state_dict(), "target_critic": state.target_critic.state_dict(),
        "world_optimizer": state.world_opt.state_dict(), "actor_optimizer": state.actor_opt.state_dict(),
        "critic_optimizer": state.critic_opt.state_dict(), "moments": state.moments.state_dict(),
        "expl_decay_steps": int(expl_decay_steps), "global_step": int(global_step), "batch_size": int(batch_size),
    }


def restore_state(state: DV3TrainState, ckpt: dict) -> None:
    """Load a checkpoint's models, optimizers and moments into `state`."""
    for key, module in (("world_model", state.world_model), ("actor", state.actor), ("critic", state.critic),
                        ("target_critic", state.target_critic)):
        module.load_state_dict(ckpt[key])
    for key, opt in (("world_optimizer", state.world_opt), ("actor_optimizer", state.actor_opt),
                     ("critic_optimizer", state.critic_opt)):
        load_optimizer_state(opt, ckpt[key])
    state.moments.load_state_dict(ckpt["moments"])


def make_optimizers(args: DreamerV3Args, world_model, actor, critic):
    """Three Adams (eps 1e-8 / 1e-5 / 1e-5, the reference's `optax.adam`
    settings, `ops/optim.py:Adam`); the step clips with
    `clip_by_global_norm` before each."""
    return (
        adam(world_model.parameters(), args.world_lr, 1e-8),
        adam(actor.parameters(), args.actor_lr, 1e-5),
        adam(critic.parameters(), args.critic_lr, 1e-5),
    )


def _grads(loss: torch.Tensor, params: list[torch.Tensor]) -> list[torch.Tensor]:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def draw_noise(args: DreamerV3Args, seq_len: int, batch: int, actions_dim: Sequence[int],
               generator: torch.Generator, device, is_continuous: bool = False) -> dict:
    """The draws of one gradient step: the Gumbels `post` [T, B, S, D] for the
    posteriors of the dynamic-learning loop and `img_prior` [H, T*B, S, D]
    for the imagined priors; `img_actions`, the imagined actions' draws:
    Gumbels, one [H+1, T*B, A_i] per discrete head, or for a continuous
    actor one tensor [H+1, T*B, A] of uniform floats in [0, 1), which the
    actor maps into (eps, 1 - eps) as the reference's draw
    (`ops/distributions.py:open_uniform`)."""
    s, d, h, n = args.stochastic_size, args.discrete_size, args.horizon, seq_len * batch
    noise = {
        "post": gumbel_noise((seq_len, batch, s, d), generator, device),
        "img_prior": gumbel_noise((h, n, s, d), generator, device),
    }
    if is_continuous:
        noise["img_actions"] = torch.rand((h + 1, n, int(sum(actions_dim))), generator=generator, device=device)
    else:
        noise["img_actions"] = [gumbel_noise((h + 1, n, a), generator, device) for a in actions_dim]
    return noise


def make_train_step(args: DreamerV3Args, cnn_keys: Sequence[str], mlp_keys: Sequence[str],
                    actions_dim: Sequence[int], is_continuous: bool, plan: CompilePlan | None = None,
                    example=None):
    """The DreamerV3 update (the reference's `make_train_step`) ->
    `train_step(state, data, tau, noise) -> metrics`: `data` holds [T, B, ...]
    tensors on the models' device (`rewards`, `dones`, `is_first`,
    `actions` and the observation keys, pixels as uint8), `tau` the EMA
    weight of the target critic (0 leaves it as it is), `noise` the draws of
    `draw_noise`. The metrics are the reference's 13, as a dict of floats.

    For a continuous actor the imagined actions are reparameterized samples
    and the actor's objective is the normalized advantage itself, so its
    gradient runs back through the critic's and reward head's values, the
    H imagined steps (the RSSM's recurrent model, kernel 2's backward, the
    transition head and its straight-through prior) and the actor's
    samples to the actor's parameters; the world model and the critic are
    frozen for it. A discrete actor's objective is `log_prob *
    sg(advantage)`. The entropy bonus is the actor's entropy, zero for a
    `tanh_normal` actor, which has none (the reference's `_policy_entropy`).

    The step has two parts. The device part, `train_step.device_step(state,
    data, tau, noise) -> the 13 metrics as one f32 tensor`, takes `tau` as a
    device scalar and holds the world, actor and critic steps and their
    three Adams; with `plan` it is registered there as "train_step" (with
    the `example` thunk), so on the card it runs as one CUDA graph. The host
    part makes the scalar and pulls the metrics (`.cpu().tolist()`)."""
    # the forwards run in the compute dtype; parameters stay f32 (every
    # layer casts its weights to its input's dtype), heads return to f32
    dt = compute_dtype(args.precision)
    remat = remat_mode(getattr(args, "remat", "off"))
    stoch_size = args.stochastic_size * args.discrete_size
    horizon = args.horizon
    splits = [int(a) for a in actions_dim]

    def world_step(state: DV3TrainState, data: dict, noise: dict):
        wm = state.world_model
        T, B = data["dones"].shape[:2]
        obs_targets = {k: data[k].float() / 255.0 for k in cnn_keys}
        obs_targets.update({k: data[k].float() for k in mlp_keys})
        batch_obs = to_compute(obs_targets, dt)
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        batch_actions = to_compute(
            torch.cat([torch.zeros_like(data["actions"][:1]), data["actions"][:-1]], dim=0), dt
        )
        embedded = wm.encoder(batch_obs)
        posterior0 = embedded.new_zeros((B, args.stochastic_size, args.discrete_size), dtype=dt)
        recurrent0 = embedded.new_zeros((B, args.recurrent_state_size), dtype=dt)
        recurrent_states, priors_logits, posteriors, posteriors_logits = wm.rssm.scan_dynamic(
            posterior0, recurrent0, batch_actions, embedded, is_first, noise["post"], remat=remat
        )
        latent_states = torch.cat([posteriors.reshape(T, B, -1), recurrent_states], dim=-1)
        reconstructed = to_float32(wm.observation_model(latent_states))
        po = {k: MSEDistribution(reconstructed[k], dims=3) for k in cnn_keys}
        po.update({k: SymlogDistribution(reconstructed[k], dims=1) for k in mlp_keys})
        pr = TwoHotEncodingDistribution(to_float32(wm.reward_model(latent_states)), dims=1)
        pc = Independent(Bernoulli(to_float32(wm.continue_model(latent_states))), 1)
        shaped = (T, B, args.stochastic_size, args.discrete_size)
        losses = reconstruction_loss(
            po, obs_targets, pr, data["rewards"], priors_logits.reshape(shaped),
            posteriors_logits.reshape(shaped), args.kl_dynamic, args.kl_representation,
            args.kl_free_nats, args.kl_regularizer, pc, 1.0 - data["dones"], args.continue_scale_factor,
        )
        params = list(wm.parameters())
        norm = apply_gradients(params, _grads(losses[0], params), state.world_opt, args.world_clip_gradients)
        return losses, norm, recurrent_states.detach(), posteriors.detach(), priors_logits.detach(), \
            posteriors_logits.detach()

    def actor_step(state: DV3TrainState, data: dict, recurrent_states, posteriors, noise: dict):
        wm, actor, critic = state.world_model, state.actor, state.critic
        T, B = data["dones"].shape[:2]
        prior = posteriors.transpose(0, 1).reshape(T * B, stoch_size)
        recurrent = recurrent_states.transpose(0, 1).reshape(T * B, args.recurrent_state_size)
        true_continue0 = (1.0 - data["dones"]).transpose(0, 1).reshape(1, T * B, 1)

        def draw(h: int) -> dict:
            if is_continuous:
                return {"uniforms": noise["img_actions"][h]}
            return {"gumbels": [g[h] for g in noise["img_actions"]]}

        def img_step(prior, recurrent, draws: dict, gumbel):
            latent = torch.cat([prior, recurrent], dim=-1)
            acts, _ = actor(latent.detach(), **draws)
            action = torch.cat(acts, dim=-1).to(prior.dtype)
            prior, recurrent = wm.rssm.imagination(prior, recurrent, action, gumbel)
            return prior, recurrent, latent, action

        # --remat also covers imagination's backward: each horizon step's
        # actor and transition activations are recomputed, not kept
        img_step = checkpoint_body(img_step, remat)
        latents, actions = [], []
        for h in range(horizon):
            prior, recurrent, latent, action = img_step(prior, recurrent, draw(h), noise["img_prior"][h])
            latents.append(latent)
            actions.append(action)
        latent_h = torch.cat([prior, recurrent], dim=-1)
        last_acts, _ = actor(latent_h.detach(), **draw(horizon))
        trajectories = torch.stack(latents + [latent_h])  # [H+1, T*B, L]
        imagined_actions = torch.stack(actions + [torch.cat(last_acts, dim=-1)])

        predicted_values = TwoHotEncodingDistribution(to_float32(critic(trajectories)), dims=1).mean
        predicted_rewards = TwoHotEncodingDistribution(to_float32(wm.reward_model(trajectories)), dims=1).mean
        continues = Independent(Bernoulli(to_float32(wm.continue_model(trajectories))), 1).mode
        continues = torch.cat([true_continue0, continues[1:]], dim=0)
        lambda_values = lambda_values_dv3(
            predicted_rewards[1:], predicted_values[1:], continues[1:] * args.gamma, lmbda=args.lmbda
        )
        discount = (torch.cumprod(continues * args.gamma, dim=0) / args.gamma).detach()
        offset, invscale = state.moments.update(lambda_values)
        advantage = (lambda_values - offset) / invscale - (predicted_values[:-1] - offset) / invscale

        policies = actor.dists(trajectories.detach())
        if is_continuous:
            # the gradient runs through the imagined trajectory
            objective = advantage
        else:
            per_head = torch.split(imagined_actions.detach(), splits, dim=-1)
            log_probs = sum(p.log_prob(a)[..., None] for p, a in zip(policies, per_head))
            objective = log_probs[:-1] * advantage.detach()
        if any(isinstance(p, TanhNormal) for p in policies):
            entropy = torch.zeros_like(objective)
        else:
            entropy = args.actor_ent_coef * sum(p.entropy() for p in policies)[..., None][:-1]
        policy_loss = -(discount[:-1] * (objective + entropy)).mean()
        params = list(actor.parameters())
        norm = apply_gradients(params, _grads(policy_loss, params), state.actor_opt, args.actor_clip_gradients)
        return policy_loss, norm, trajectories.detach(), lambda_values.detach(), discount

    def critic_step(state: DV3TrainState, trajectories, lambda_values, discount):
        traj_sg = trajectories[:-1]
        with torch.no_grad():
            target_values = TwoHotEncodingDistribution(to_float32(state.target_critic(traj_sg)), dims=1).mean
        qv = TwoHotEncodingDistribution(to_float32(state.critic(traj_sg)), dims=1)
        value_loss = -qv.log_prob(lambda_values) - qv.log_prob(target_values)
        value_loss = (value_loss * discount[:-1, :, 0]).mean()
        params = list(state.critic.parameters())
        norm = apply_gradients(params, _grads(value_loss, params), state.critic_opt, args.critic_clip_gradients)
        return value_loss, norm

    def device_step(state: DV3TrainState, data: dict, tau: torch.Tensor, noise: dict) -> torch.Tensor:
        # EMA target-critic update before the gradient step, with the
        # pre-update critic (the reference's ordering). `tau` is a device
        # scalar applied at every step, as in the reference: with a finite
        # critic, 0 * c + 1 * t is t bit for bit
        with torch.no_grad():
            for t, c in zip(state.target_critic.parameters(), state.critic.parameters()):
                t.copy_(tau * c + (1.0 - tau) * t)
        losses, wm_norm, recurrent_states, posteriors, priors_logits, posteriors_logits = world_step(
            state, data, noise
        )
        # imagination differentiates through the actions only: the world
        # model and the critic are constants of the actor's loss
        frozen = (state.world_model, state.critic)
        for m in frozen:
            m.requires_grad_(False)
        try:
            policy_loss, actor_norm, trajectories, lambda_values, discount = actor_step(
                state, data, recurrent_states, posteriors, noise
            )
        finally:
            for m in frozen:
                m.requires_grad_(True)
        value_loss, critic_norm = critic_step(state, trajectories, lambda_values, discount)

        T, B = data["dones"].shape[:2]
        shaped = (T, B, args.stochastic_size, args.discrete_size)
        with torch.no_grad():
            post_entropy = OneHotCategorical(posteriors_logits.reshape(shaped)).entropy().sum(-1).mean()
            prior_entropy = OneHotCategorical(priors_logits.reshape(shaped)).entropy().sum(-1).mean()
        rec_loss, kl, state_loss, reward_loss, observation_loss, continue_loss = losses
        return torch.stack([
            rec_loss, observation_loss, reward_loss, state_loss, continue_loss, policy_loss, value_loss,
            kl, post_entropy, prior_entropy, wm_norm, actor_norm, critic_norm,
        ]).detach().float()

    step = device_step if plan is None else plan.register("train_step", device_step, example=example, role="update")

    def train_step(state: DV3TrainState, data: dict, tau: float, noise: dict) -> dict[str, float]:
        tau_t = torch.full((), float(tau), device=data["dones"].device)
        return dict(zip(METRICS, step(state, data, tau_t, noise).cpu().tolist()))

    train_step.device_step = step
    return train_step


def _random_actions(rng: np.random.Generator, action_space, actions_dim: Sequence[int], is_continuous: bool,
                    n_envs: int) -> np.ndarray:
    """The learning-starts warm-up's actions, `action_space.sample()` an env
    (the reference's `_random_actions`): uniform one-hot actions per head,
    concatenated, [n_envs, sum(A)]; for a Box, float32 [n_envs, A] drawn as
    gymnasium draws a coordinate: uniform in [low, high] where both bounds
    are finite (Pendulum-v1), a standard normal where neither is
    (continuous_dummy)."""
    if not is_continuous:
        return np.concatenate(
            [np.eye(a, dtype=np.float32)[rng.integers(0, a, n_envs)] for a in actions_dim], axis=-1
        )
    shape = (n_envs, int(sum(actions_dim)))
    low = np.broadcast_to(np.asarray(action_space.low, np.float64).reshape(-1), shape[1:])
    high = np.broadcast_to(np.asarray(action_space.high, np.float64).reshape(-1), shape[1:])
    bounded = np.isfinite(low) & np.isfinite(high)
    uniform = rng.uniform(np.where(bounded, low, 0.0), np.where(bounded, high, 1.0), size=shape)
    return np.where(bounded, uniform, rng.normal(size=shape)).astype(np.float32)


def _env_actions(actions: np.ndarray, actions_dim: Sequence[int], is_continuous: bool) -> list:
    """[n_envs, sum(A)] action rows -> one env action per env: for discrete
    heads the argmax (an int, or a list of ints for several heads), for
    continuous actions the row itself (the reference passes them through)."""
    if is_continuous:
        return list(actions)
    heads = np.split(actions, np.cumsum(actions_dim)[:-1], axis=-1)
    idx = np.stack([h.argmax(-1) for h in heads], axis=-1)
    return [int(r[0]) if len(actions_dim) == 1 else r.tolist() for r in idx]


def _params_delta(start: dict[str, list[torch.Tensor]], state: DV3TrainState) -> dict[str, float]:
    modules = {"world_model": state.world_model, "actor": state.actor, "critic": state.critic}
    return {
        f"Params/{name}_delta": float(torch.sqrt(sum(
            ((p.detach() - p0) ** 2).sum() for p, p0 in zip(modules[name].parameters(), start[name])
        )))
        for name in modules
    }


@register_algorithm()
def main(argv: Sequence[str] | None = None) -> None:
    # with --checkpoint_path, the checkpoint's own config under the command
    # line's explicit flags (reference :507-514)
    args = parse_run_args(DreamerV3Args, argv)
    # fixed by the 4-stage 64x64 conv trunk
    args.screen_size = 64
    args.frame_stack = -1
    device = resolve_device(args.device)
    check_num_devices(args.num_devices, device, args.seq_devices)
    if device.type == "cuda":
        # the reference's float32 products are true float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    noise_gen = torch.Generator(device=device).manual_seed(args.seed)

    device_envs = args.env_backend == "jax"
    if device_envs:
        if args.memmap_buffer:
            raise ValueError("--env_backend jax writes rollouts into the device replay ring; drop --memmap_buffer")
        # the Anakin arrangement: envs and player on the device, a chunk of
        # collection one graph replay writing into the device ring
        venv = VecDeviceEnv(make_device_env(args.env_id), args.num_envs, device)
        envs, observation_space, action_space = None, venv.single_observation_space, venv.single_action_space
    else:
        envs = make_vector_env(
            [make_dict_env(args.env_id, args.seed + i, rank=0, args=args, vector_env_idx=i)
             for i in range(args.num_envs)],
            sync=args.sync_env or args.num_envs == 1,
        )
        observation_space, action_space = envs.single_observation_space, envs.single_action_space
    cnn_keys, mlp_keys = validate_obs_keys(observation_space, args)
    obs_keys = [*cnn_keys, *mlp_keys]
    actions_dim, is_continuous = actions_dim_of(action_space)

    logger, run_dir = create_logger(args, "dreamer_v3")
    telem = Telemetry.from_args(args, run_dir, algo="dreamer_v3")
    profiler = StepProfiler.from_args(args, run_dir)

    world_model, actor, critic, target_critic = build_models(
        torch.Generator().manual_seed(args.seed), actions_dim, is_continuous, args,
        observation_space.spaces, cnn_keys, mlp_keys,
    )
    for m in (world_model, actor, critic, target_critic):
        m.to(device)
    # --remat auto: measured on this run's scan before the step reads args.remat
    maybe_decide_remat("dreamer_v3", world_model, args, int(sum(actions_dim)), telem,
                       store_path=os.path.join(run_dir, "decisions.json"))
    state = DV3TrainState(
        world_model, actor, critic, target_critic,
        *make_optimizers(args, world_model, actor, critic),
        Moments(args.moments_decay, args.moment_max, args.moments_percentile_low,
                args.moments_percentile_high, device=device),
    )
    expl_decay_steps, start_step, resumed = 0, 1, None
    if args.checkpoint_path:
        t0 = time.perf_counter()
        ckpt = load_checkpoint(args.checkpoint_path, device)
        restore_state(state, ckpt)
        expl_decay_steps = int(ckpt["expl_decay_steps"])
        start_step = int(ckpt["global_step"]) + 1
        resumed = {"checkpoint": os.path.abspath(args.checkpoint_path), "start_step": start_step,
                   "load_ms": (time.perf_counter() - t0) * 1e3}
        del ckpt
    start_params = {
        "world_model": [p.detach().clone() for p in world_model.parameters()],
        "actor": [p.detach().clone() for p in actor.parameters()],
        "critic": [p.detach().clone() for p in critic.parameters()],
    }
    player = PlayerDV3(
        world_model.encoder, world_model.rssm, actor, actions_dim=actions_dim,
        stochastic_size=args.stochastic_size, discrete_size=args.discrete_size,
        recurrent_state_size=args.recurrent_state_size, is_continuous=is_continuous,
        compute_dtype=args.precision,
    )
    preprocess = make_device_preprocess(cnn_keys)
    n_envs = args.num_envs
    if args.dry_run:
        # one iteration: the first (and only) training samples from the one
        # row each env ring holds
        args.per_rank_sequence_length = min(args.per_rank_sequence_length, max(args.train_every // n_envs, 1))

    # the hot steps as CUDA graphs on the card (compile/plan.py): the
    # gradient step and the player step, with example arguments of their
    # shapes for --warm_compile on
    plan = CompilePlan.from_args(args, telem)
    telem.add_gauges(plan.gauges)

    def _train_example():
        T, B = args.per_rank_sequence_length, args.per_rank_batch_size
        data = obs_zeros(observation_space.spaces, obs_keys, (T, B), device)
        data["actions"] = torch.zeros((T, B, int(sum(actions_dim))), device=device)
        data.update({k: torch.zeros((T, B, 1), device=device) for k in ("rewards", "dones", "is_first")})
        noise = draw_noise(args, T, B, actions_dim, torch.Generator(device=device).manual_seed(0), device,
                           is_continuous)
        return state, data, torch.ones((), device=device), noise

    train_step = make_train_step(args, cnn_keys, mlp_keys, actions_dim, is_continuous, plan=plan,
                                 example=_train_example)

    def _player_step(player, player_state, obs: dict, uniform, expl):
        with torch.no_grad():
            return player.noisy_step(player_state, preprocess(obs), uniform, expl)

    if not device_envs:
        player_step = plan.register("player_step", _player_step, example=lambda: (
            player, player.init_states(n_envs), obs_zeros(observation_space.spaces, obs_keys, (n_envs,), device),
            player.draw_noise(n_envs, torch.Generator(device=device).manual_seed(0), device),
            torch.zeros((), device=device)))
    buffer_size = args.buffer_size // n_envs if not args.dry_run else 2
    # the replay ring on the device unless --memmap_buffer keeps it in host
    # memmap files (the reference's choice, dreamer_v3.py:826-830)
    rb = AsyncReplayBuffer(max(buffer_size, args.per_rank_sequence_length), n_envs, seed=args.seed,
                           **(dict(storage="host", memmap_dir=os.path.join(run_dir, "memmap_buffer"))
                              if args.memmap_buffer else dict(storage="device", device=device)))
    buffer_ckpt = os.path.abspath(args.checkpoint_path) + "_buffer.npz" if args.checkpoint_path else None
    if buffer_ckpt and args.checkpoint_buffer and os.path.exists(buffer_ckpt) and not args.eval_only:
        rb.load(buffer_ckpt)
        resumed["buffer"] = buffer_ckpt
    step_before_training = args.train_every // n_envs
    num_updates = args.total_steps // n_envs if not args.dry_run else 1
    learning_starts = args.learning_starts // n_envs if not args.dry_run else 0
    if args.checkpoint_path and not args.checkpoint_buffer:
        learning_starts += start_step
    max_step_expl_decay = args.max_step_expl_decay // args.gradient_steps
    expl_amount = args.expl_amount
    if args.checkpoint_path and max_step_expl_decay > 0:
        expl_amount = polynomial_decay(expl_decay_steps, initial=args.expl_amount, final=args.expl_min,
                                       max_decay_steps=max_step_expl_decay)
    if resumed is not None:
        resumed.update(learning_starts=learning_starts, expl_amount=expl_amount)

    chunk, anakin = 1, None
    if device_envs:
        chunk = max(min(args.train_every // n_envs, num_updates - start_step + 1), 1)
        with torch.no_grad():  # updated in place by the collector, outside inference mode
            player_state = player.init_states(n_envs)
        carry = DreamerCollectorCarry.reset(venv, noise_gen)
        sample_random = random_action_sampler(action_space, actions_dim, is_continuous)

        def _draws(generator: torch.Generator, random_phase: bool) -> tuple:
            """A chunk's reset states, and its random actions or the player's uniforms."""
            fresh = venv.draw_resets(generator, chunk)
            if random_phase:
                return fresh, sample_random(generator, chunk, n_envs)
            return fresh, torch.rand((chunk, n_envs, player.noise_width()), generator=generator, device=device)

        def _collector(random_phase: bool):
            name = "anakin_rollout_random" if random_phase else "anakin_rollout"
            fn = make_dreamer_collector(venv, chunk, actions_dim, is_continuous, preprocess,
                                        clip_rewards=args.clip_rewards, random_actions=random_phase)
            # one replay is one chunk; the graph reads and writes the carry's
            # and the player state's own tensors (adopt)
            return plan.register(name, fn, adopt=True, example=lambda: (
                player, player_state, carry, *_draws(torch.Generator(device=device).manual_seed(0), random_phase),
                torch.zeros((), device=device)))

        collect, collect_random = _collector(False), _collector(True)
        anakin = AnakinStats(scan_span=chunk, env_batch=n_envs, devices=1)
    else:
        obs = envs.reset(seed=args.seed)[0]
        step_data = {k: obs[k] for k in obs_keys}
        step_data["dones"] = np.zeros((n_envs, 1), np.float32)
        step_data["rewards"] = np.zeros((n_envs, 1), np.float32)
        step_data["is_first"] = np.ones((n_envs, 1), np.float32)
        with torch.inference_mode():
            player_state = player.init_states(n_envs)
    aggregator = MetricAggregator()
    # restarts at 0 on a resume, as in the reference (:1027): the first
    # gradient step after it takes tau 1
    gradient_steps = player_steps = env_steps = 0
    policy_collect_s, step_ms, chunk_ms, checkpoints = 0.0, [], [], []
    plan.start()
    start = time.perf_counter()
    if args.eval_only:
        num_updates = start_step - 1  # no training: straight to the test episodes
    # a chunk of the device path names its last step; a trailing partial
    # chunk is dropped
    steps_iter = range(start_step + chunk - 1, num_updates + 1, chunk)
    last_step = steps_iter[-1] if len(steps_iter) else num_updates
    for global_step in steps_iter:
        t0 = time.perf_counter()
        telem.mark("rollout")
        if device_envs:
            random_phase = global_step <= learning_starts and not args.checkpoint_path
            idx = rb.reserve(chunk)
            traj, ep = (collect_random if random_phase else collect)(
                player, player_state, carry, *_draws(noise_gen, random_phase),
                torch.full((), float(expl_amount), device=device))
            rb.add_direct(traj, idx, chunk)
            # the one pull of a chunk (the device has retired it when it lands)
            n_ep, return_sum, length_sum = torch.stack([ep["episodes"], ep["return_sum"], ep["length_sum"]]).tolist()
            for _ in range(int(n_ep)):  # the chunk's mean, once an episode
                aggregator.update("Rewards/rew_avg", return_sum / n_ep)
                aggregator.update("Game/ep_len_avg", length_sum / n_ep)
            env_steps += chunk * n_envs
            anakin.note(chunk * n_envs, time.perf_counter() - t0)
            if not random_phase:
                player_steps += chunk
                policy_collect_s += time.perf_counter() - t0
                chunk_ms.append((time.perf_counter() - t0) * 1e3)
        else:
            if global_step <= learning_starts:
                actions = _random_actions(rng, action_space, actions_dim, is_continuous, n_envs)
            else:
                with torch.inference_mode():
                    dev_obs = {k: torch.from_numpy(step_data[k]).to(device) for k in obs_keys}
                    player_state, acts = player_step(player, player_state, dev_obs,
                                                     player.draw_noise(n_envs, noise_gen, device),
                                                     torch.full((), float(expl_amount), device=device))
                actions = acts.float().cpu().numpy()
                player_steps += 1
            step_data["actions"] = actions
            rb.add({k: v[None] for k, v in step_data.items()})

            # same-step autoreset: an ended episode's last observation is in
            # its info, the returned one is already the reset one
            obs, rewards, terms, truncs, infos = envs.step(_env_actions(actions, actions_dim, is_continuous))
            dones = np.logical_or(terms, truncs).astype(np.float32)
            for info in infos:
                if "episode" in info:
                    aggregator.update("Rewards/rew_avg", float(info["episode"]["r"]))
                    aggregator.update("Game/ep_len_avg", float(info["episode"]["l"]))
            env_steps += n_envs
            step_data = {k: obs[k] for k in obs_keys}
            step_data["is_first"] = np.zeros((n_envs, 1), np.float32)
            step_data["dones"] = dones[:, None]
            step_data["rewards"] = (np.tanh(rewards) if args.clip_rewards else rewards)[:, None].astype(np.float32)
            done_idx = np.nonzero(dones)[0].tolist()
            if done_idx:
                # terminal rows carry the true final observation and zero actions
                reset_data = {k: np.stack([infos[i]["final_observation"][k] for i in done_idx])[None]
                              for k in obs_keys}
                reset_data["dones"] = np.ones((1, len(done_idx), 1), np.float32)
                reset_data["actions"] = np.zeros((1, len(done_idx), int(sum(actions_dim))), np.float32)
                reset_data["rewards"] = step_data["rewards"][done_idx][None]
                reset_data["is_first"] = np.zeros((1, len(done_idx), 1), np.float32)
                rb.add(reset_data, done_idx)
                step_data["rewards"][done_idx] = 0.0
                step_data["dones"][done_idx] = 0.0
                step_data["is_first"][done_idx] = 1.0
                mask = torch.zeros(n_envs, device=device)
                mask[done_idx] = 1.0
                with torch.inference_mode():
                    player_state = player.reset_states(player_state, mask)
            if global_step > learning_starts:
                policy_collect_s += time.perf_counter() - t0
        step_before_training -= chunk

        if global_step >= learning_starts and step_before_training <= 0:
            # a chunk never lands on learning_starts exactly: the first chunk
            # at or past it is the pretrain moment
            first = global_step - chunk < learning_starts if device_envs else global_step == learning_starts
            n_samples = args.pretrain_steps if first else args.gradient_steps
            telem.mark("buffer/sample")
            local = rb.sample(args.per_rank_batch_size, sequence_length=args.per_rank_sequence_length,
                              n_samples=n_samples)
            telem.mark("train/dispatch")
            t1 = time.perf_counter()
            for i in range(n_samples):
                if gradient_steps % args.critic_target_network_update_freq == 0:
                    tau = 1.0 if gradient_steps == 0 else args.critic_tau
                else:
                    tau = 0.0
                data = {k: v[i] if torch.is_tensor(v) else torch.from_numpy(v[i]).to(device) for k, v in local.items()}
                noise = draw_noise(args, args.per_rank_sequence_length, args.per_rank_batch_size,
                                   actions_dim, noise_gen, device, is_continuous)
                # the metrics stay on the device (a copy: the next replay
                # overwrites the graph's output) until the log's one pull
                metrics = train_step.device_step(state, data, torch.full((), float(tau), device=device),
                                                 noise).clone()
                for name, value in zip(METRICS, metrics):
                    aggregator.update(name, value)
                profiler.tick()
                gradient_steps += 1
            step_before_training = args.train_every // n_envs
            if args.expl_decay:
                expl_decay_steps += 1
                expl_amount = polynomial_decay(
                    expl_decay_steps, initial=args.expl_amount, final=args.expl_min,
                    max_decay_steps=max_step_expl_decay,
                )
            aggregator.update("Params/exploration_amount", expl_amount)
            telem.mark("log")
            sps = (global_step - start_step + 1) * n_envs / (time.perf_counter() - start)
            rec = aggregator.compute()
            aggregator.reset()
            telem.interval(rec, global_step, sps)
            # each gradient step's host wall: this event's, its one pull included
            step_ms.extend([(time.perf_counter() - t1) * 1e3 / n_samples] * n_samples)
            rec.update(step=global_step, gradient_steps=gradient_steps, sps=sps)
            logger.record(rec)
            print(f"[dreamer_v3] step {global_step} grad_steps {gradient_steps} "
                  f"rec_loss {rec['Loss/reconstruction_loss']:.4f} policy_loss {rec['Loss/policy_loss']:.4f} "
                  f"value_loss {rec['Loss/value_loss']:.4f}", flush=True)

        if (args.checkpoint_every > 0 and global_step % args.checkpoint_every == 0) or args.dry_run \
                or global_step == last_step:
            ckpt_path = os.path.join(run_dir, "checkpoints", f"ckpt_{global_step}")
            t_save = time.perf_counter()
            nbytes = save_checkpoint(
                ckpt_path, checkpoint_state(state, expl_decay_steps, global_step, args.per_rank_batch_size), args
            )
            if args.checkpoint_buffer:
                rb.save(ckpt_path + "_buffer.npz")
            checkpoints.append({"path": ckpt_path, "step": global_step, "bytes": nbytes,
                                "save_ms": (time.perf_counter() - t_save) * 1e3})

    profiler.close()
    if envs is not None:
        envs.close()
    plan.close()
    test_steps: list[int] = []

    def episode() -> float:
        ret, steps = test(player, logger, args, cnn_keys, sample_actions=True)
        test_steps.append(steps)
        return ret

    t_test = time.perf_counter()
    test_returns = run_test_episodes(episode, args, logger)
    test_ms = (time.perf_counter() - t_test) * 1e3
    summary = {
        "event": "done", "env_steps": env_steps, "policy_steps": num_updates, "player_steps": player_steps,
        "gradient_steps": gradient_steps, "train_step_ms": step_ms,
        # env steps a second while the player acts (the random phase excluded)
        "policy_env_steps_per_s": player_steps * n_envs / policy_collect_s if policy_collect_s > 0 else None,
        "device": str(device), "checkpoints": checkpoints, "resumed": resumed,
        "test_returns": test_returns, "test_player_steps": test_steps, "test_ms": test_ms,
        **_params_delta(start_params, state), "compile": plan.gauges(), "compile_stats": plan.stats(),
        "env_backend": args.env_backend, "anakin_chunk": chunk if device_envs else None,
        # each player chunk's host wall: draws, replay, add_direct, the pull
        "anakin_chunk_ms": chunk_ms,
        "anakin": anakin.gauges() if anakin is not None else None,
        "remat": args.remat, "profile": profiler.trace_path if args.profile else None,
        "vector_env": None if envs is None else {
            "kind": type(envs).__name__, "workers": len(getattr(envs, "processes", ()))},
    }
    telem.close()
    logger.record(summary)
    print(f"[dreamer_v3] done: {gradient_steps} gradient steps, {env_steps} env steps, run dir {run_dir}",
          flush=True)
