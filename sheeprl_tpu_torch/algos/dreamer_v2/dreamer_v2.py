"""DreamerV2 training (the port of sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py):
`make_optimizers`, `make_train_step` and a synchronous `main` over
`num_envs` host envs.

    python -m sheeprl_tpu_torch dreamer_v2 --env_id discrete_dummy --cnn_keys rgb [--device cpu]
    python -m sheeprl_tpu_torch dreamer_v2 --env_id discrete_dummy --cnn_keys rgb --buffer_type episode \\
        --prioritize_ends

One gradient step follows the reference's `make_train_step`: the hard
target-critic copy `target = tau * critic + (1 - tau) * target` with `tau`
a device scalar (1 every `critic_target_network_update_freq` gradient
steps, else 0); the world model's update (Normal(x, 1) observation and
reward likelihoods, the continue Bernoulli with `--use_continues`, the
alpha-balanced KL with free nats, `loss.py`); imagination over `horizon`
steps with the updated world model; the actor's update on `objective_mix`
of REINFORCE and dynamics backpropagation with lambda returns bootstrapped
from the target critic; the critic's update. Three Adams (eps 1e-5) each
behind optax's `clip_by_global_norm(clip_gradients)` and
`add_decayed_weights(1e-6)`, written by hand (`ops/optim.py`). Every draw
of the step is given (`dreamer_v3.py:draw_noise`); on the card the step is
one CUDA graph (`compile/plan.py`, "train_step"), and so is the player's
(`PlayerDV2.noisy_step`, "player_step").

The replay rows keep the reference's V2 layout: a row is (o_t, a_t, r_t,
d_t, is_first_t), where a_t is the action that led to o_t. `--buffer_type
sequential` stores them in per-env rings (`AsyncReplayBuffer`, on the
device unless `--memmap_buffer`); `episode` gathers each env's rows until
its episode ends and stores whole episodes of at least
`per_rank_sequence_length` rows (`EpisodeBuffer`, on the host,
`--prioritize_ends` biasing the windows toward episode ends); a sample is
copied to the device once, whole, before its gradient steps. The first
gradient steps, at `learning_starts`, are `pretrain_steps` of them.

Checkpoints, resume, `--checkpoint_buffer` and `--eval_only` work as in
`algos/dreamer_v3/dreamer_v3.py`, under the reference's key contract
(`checkpoint_state`); the run ends with `--test_episodes` greedy episodes
(`utils.py:test`). `--precision bfloat16` follows `ops/precision.py`. No
kernel runs on this path: the VALID ELU convolutions and the biased GRU
are outside every kernel's guard (`agent.py`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ...compile.decisions import remat_mode
from ...compile.plan import CompilePlan
from ...compile.specs import dict_obs_spec, dreamer_sample_spec
from ...data.buffers import AsyncReplayBuffer, EpisodeBuffer
from ...envs.vector import make_vector_env
from ...nn.blocks import MLP
from ...ops.distributions import Bernoulli, Independent, Normal, OneHotCategorical, TanhNormal
from ...ops.math import lambda_values_dv2, polynomial_decay
from ...ops.optim import adam, apply_gradients, load_optimizer_state
from ...ops.precision import compute_dtype, to_compute, to_float32
from ...ops.scan import checkpoint_body
from ...telemetry.core import Telemetry
from ...utils.checkpoint import load_checkpoint, save_checkpoint
from ...utils.device import check_num_devices, resolve_device
from ...utils.env import make_dict_env
from ...utils.evaluation import parse_run_args, run_test_episodes
from ...utils.logger import create_logger
from ...utils.metric import MetricAggregator
from ...utils.profiler import StepProfiler
from ...utils.registry import register_algorithm
from ..dreamer_v3.agent import Actor, WorldModel
from ..dreamer_v3.dreamer_v3 import METRICS, _env_actions, _grads, _params_delta, _random_actions, draw_noise
from ..ppo.ppo import actions_dim_of, validate_obs_keys
from .agent import PlayerDV2, build_models
from .args import DreamerV2Args
from .loss import reconstruction_loss
from .utils import make_device_preprocess, maybe_decide_remat, test

__all__ = [
    "DREAMER_V2", "DV2TrainState", "Family", "checkpoint_state", "main", "make_optimizers", "make_train_step",
    "restore_state", "run",
]

# optax.add_decayed_weights(1e-6) in each of the reference's three chains
WEIGHT_DECAY = 1e-6
# the scalar columns of a V2 replay row
ROW_KEYS = ("rewards", "dones", "is_first")


@dataclasses.dataclass
class DV2TrainState:
    """The models and their optimizers; a train step updates them in place."""

    world_model: WorldModel
    actor: Actor
    critic: MLP
    target_critic: MLP
    world_opt: torch.optim.Optimizer
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer


MODULES = ("world_model", "actor", "critic", "target_critic")
OPTIMIZERS = (("world_optimizer", "world_opt"), ("actor_optimizer", "actor_opt"), ("critic_optimizer", "critic_opt"))


def checkpoint_state(state, expl_decay_steps: int, global_step: int, batch_size: int) -> dict:
    """What a checkpoint holds, under the reference's key contract
    (`dreamer_v2.py:791-806`; DreamerV1's the same without the target
    critic): each model's and optimizer's state_dict and the counters."""
    out = {k: getattr(state, k).state_dict() for k in MODULES if hasattr(state, k)}
    out.update({key: getattr(state, attr).state_dict() for key, attr in OPTIMIZERS})
    out.update(expl_decay_steps=int(expl_decay_steps), global_step=int(global_step), batch_size=int(batch_size))
    return out


def restore_state(state, ckpt: dict) -> None:
    """Load a checkpoint's models and optimizers into `state`."""
    for k in MODULES:
        if hasattr(state, k):
            getattr(state, k).load_state_dict(ckpt[k])
    for key, attr in OPTIMIZERS:
        load_optimizer_state(getattr(state, attr), ckpt[key])


def make_optimizers(args: DreamerV2Args, world_model, actor, critic):
    """Three Adams at eps 1e-5 (the reference's `optax.adam(lr, eps=1e-5)`);
    the step clips and decays before each (`apply_gradients`)."""
    return (adam(world_model.parameters(), args.world_lr, 1e-5), adam(actor.parameters(), args.actor_lr, 1e-5),
            adam(critic.parameters(), args.critic_lr, 1e-5))


def make_train_step(args: DreamerV2Args, cnn_keys: Sequence[str], mlp_keys: Sequence[str],
                    actions_dim: Sequence[int], is_continuous: bool, plan: CompilePlan | None = None,
                    example=None):
    """The DreamerV2 update (the reference's `make_train_step`) ->
    `train_step(state, data, tau, noise) -> metrics`: `data` holds [T, B, ...]
    tensors on the models' device (`rewards`, `dones`, `is_first`,
    `actions` and the observation keys, pixels as uint8), `tau` the weight
    of the hard target-critic copy (1 copies, 0 keeps), `noise` the draws of
    `dreamer_v3.py:draw_noise` (its last imagined-action draw is not read:
    V2 imagines `horizon` actions). The metrics are the reference's 13.
    `train_step.device_step(state, data, tau, noise)` is the part on the
    device, `tau` a device scalar, registered with `plan` as "train_step"
    when a plan is given; it returns the 13 metrics as one f32 tensor."""
    dt = compute_dtype(args.precision)
    remat = remat_mode(getattr(args, "remat", "off"))
    stoch_size = args.stochastic_size * args.discrete_size
    horizon = args.horizon
    splits = [int(a) for a in actions_dim]
    clip = args.clip_gradients if args.clip_gradients is not None and args.clip_gradients > 0 else None

    def world_step(state: DV2TrainState, data: dict, noise: dict):
        wm = state.world_model
        T, B = data["dones"].shape[:2]
        obs_targets = {k: data[k].float() / 255.0 - 0.5 for k in cnn_keys}
        obs_targets.update({k: data[k].float() for k in mlp_keys})
        is_first = data["is_first"].clone()
        is_first[0] = 1.0
        embedded = wm.encoder(to_compute(obs_targets, dt))
        posterior0 = embedded.new_zeros((B, args.stochastic_size, args.discrete_size), dtype=dt)
        recurrent0 = embedded.new_zeros((B, args.recurrent_state_size), dtype=dt)
        recurrent_states, priors_logits, posteriors, posteriors_logits = wm.rssm.scan_dynamic(
            posterior0, recurrent0, data["actions"].to(dt), embedded, is_first, noise["post"], remat=remat
        )
        latent_states = torch.cat([posteriors.reshape(T, B, -1), recurrent_states], dim=-1)
        decoded = to_float32(wm.observation_model(latent_states))
        po = {k: Independent(Normal(v, torch.ones_like(v)), v.dim() - 2) for k, v in decoded.items()}
        reward_mean = to_float32(wm.reward_model(latent_states))
        pr = Independent(Normal(reward_mean, torch.ones_like(reward_mean)), 1)
        pc = continue_targets = None
        if args.use_continues:
            pc = Independent(Bernoulli(to_float32(wm.continue_model(latent_states))), 1)
            continue_targets = (1.0 - data["dones"]) * args.gamma
        shaped = (T, B, args.stochastic_size, args.discrete_size)
        losses = reconstruction_loss(
            po, obs_targets, pr, data["rewards"], priors_logits.reshape(shaped), posteriors_logits.reshape(shaped),
            args.kl_balancing_alpha, args.kl_free_nats, args.kl_free_avg, args.kl_regularizer, pc,
            continue_targets, args.continue_scale_factor,
        )
        params = list(wm.parameters())
        norm = apply_gradients(params, _grads(losses[0], params), state.world_opt, clip, WEIGHT_DECAY)
        return losses, norm, recurrent_states.detach(), posteriors.detach(), priors_logits.detach(), \
            posteriors_logits.detach()

    def actor_step(state: DV2TrainState, data: dict, recurrent_states, posteriors, noise: dict):
        wm, actor, target_critic = state.world_model, state.actor, state.target_critic
        T, B = data["dones"].shape[:2]
        prior = posteriors.transpose(0, 1).reshape(T * B, stoch_size)
        recurrent = recurrent_states.transpose(0, 1).reshape(T * B, args.recurrent_state_size)
        latent0 = torch.cat([prior, recurrent], dim=-1)

        def img_step(prior, recurrent, draws: dict, gumbel):
            latent = torch.cat([prior, recurrent], dim=-1)
            acts, _ = actor(latent.detach(), **draws)
            action = torch.cat(acts, dim=-1).to(prior.dtype)
            prior, recurrent = wm.rssm.imagination(prior, recurrent, action, gumbel)
            return prior, recurrent, action

        img_step = checkpoint_body(img_step, remat)
        latents, actions = [latent0], []
        for h in range(horizon):
            draws = ({"uniforms": noise["img_actions"][h]} if is_continuous
                     else {"gumbels": [g[h] for g in noise["img_actions"]]})
            prior, recurrent, action = img_step(prior, recurrent, draws, noise["img_prior"][h])
            latents.append(torch.cat([prior, recurrent], dim=-1))
            actions.append(action)
        trajectories = torch.stack(latents)  # [H+1, T*B, L]
        # entry i is reached by action i; the first is the zero action
        imagined_actions = torch.stack([torch.zeros_like(actions[0])] + actions)

        target_values = to_float32(target_critic(trajectories))
        predicted_rewards = to_float32(wm.reward_model(trajectories))
        if args.use_continues:
            continues = Independent(Bernoulli(to_float32(wm.continue_model(trajectories))), 1).mean
            true_continue0 = (1.0 - data["dones"]).transpose(0, 1).reshape(1, T * B, 1) * args.gamma
            continues = torch.cat([true_continue0, continues[1:]], dim=0)
        else:
            continues = torch.ones_like(predicted_rewards.detach()) * args.gamma
        lambda_values = lambda_values_dv2(predicted_rewards[:-1], target_values[:-1], continues[:-1],
                                          bootstrap=target_values[-1:], lmbda=args.lmbda)  # [H, T*B, 1]
        discount = torch.cumprod(torch.cat([torch.ones_like(continues[:1]), continues[:-1]], dim=0), dim=0).detach()

        policies = actor.dists(trajectories[:-2].detach())
        dynamics = lambda_values[1:]
        advantage = (lambda_values[1:] - target_values[:-2]).detach()
        per_head = torch.split(imagined_actions[1:-1].detach(), splits, dim=-1)
        reinforce = sum(p.log_prob(a)[..., None] for p, a in zip(policies, per_head)) * advantage
        objective = args.objective_mix * reinforce + (1 - args.objective_mix) * dynamics
        if any(isinstance(p, TanhNormal) for p in policies):
            entropy = torch.zeros_like(objective)
        else:
            entropy = args.actor_ent_coef * sum(p.entropy() for p in policies)[..., None]
        policy_loss = -(discount[:-2] * (objective + entropy)).mean()
        params = list(actor.parameters())
        norm = apply_gradients(params, _grads(policy_loss, params), state.actor_opt, clip, WEIGHT_DECAY)
        return policy_loss, norm, trajectories.detach(), lambda_values.detach(), discount

    def critic_step(state: DV2TrainState, trajectories, lambda_values, discount):
        value_mean = to_float32(state.critic(trajectories[:-1]))
        qv = Independent(Normal(value_mean, torch.ones_like(value_mean)), 1)
        value_loss = -(discount[:-1, :, 0] * qv.log_prob(lambda_values)).mean()
        params = list(state.critic.parameters())
        norm = apply_gradients(params, _grads(value_loss, params), state.critic_opt, clip, WEIGHT_DECAY)
        return value_loss, norm

    def device_step(state: DV2TrainState, data: dict, tau: torch.Tensor, noise: dict) -> torch.Tensor:
        # the hard copy, gated by a device scalar: 1 * c + 0 * t is c, and
        # 0 * c + 1 * t is t, bit for bit (the reference's arithmetic)
        with torch.no_grad():
            for t, c in zip(state.target_critic.parameters(), state.critic.parameters()):
                t.copy_(tau * c + (1.0 - tau) * t)
        losses, wm_norm, recurrent_states, posteriors, priors_logits, posteriors_logits = world_step(
            state, data, noise)
        # the actor's loss differentiates through the imagined actions only
        frozen = (state.world_model, state.target_critic)
        for m in frozen:
            m.requires_grad_(False)
        try:
            policy_loss, actor_norm, trajectories, lambda_values, discount = actor_step(
                state, data, recurrent_states, posteriors, noise)
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
            kl.mean(), post_entropy, prior_entropy, wm_norm, actor_norm, critic_norm,
        ]).detach().float()

    step = device_step if plan is None else plan.register("train_step", device_step, example=example, role="update")

    def train_step(state: DV2TrainState, data: dict, tau: float, noise: dict) -> dict[str, float]:
        tau_t = torch.full((), float(tau), device=data["dones"].device)
        return dict(zip(METRICS, step(state, data, tau_t, noise).cpu().tolist()))

    train_step.device_step = step
    return train_step


def _host_obs(obs: dict, keys: Sequence[str], cnn_keys: Sequence[str]) -> dict:
    """An observation dict as the replay rows and the player take it: pixels
    uint8, everything else float32."""
    return {k: np.asarray(obs[k], dtype=np.uint8 if k in cnn_keys else np.float32) for k in keys}


@dataclasses.dataclass(frozen=True)
class Family:
    """What `run` needs of a Dreamer V1 or V2: its models, state, player,
    train step and draws, the scalar columns of its replay rows, and
    whether its step takes the target critic's `tau`."""

    algo: str
    build_models: Callable
    state: type
    make_optimizers: Callable
    player: type
    make_train_step: Callable
    draw_noise: Callable  # (args, T, B, actions_dim, generator, device, is_continuous) -> the step's draws
    row_keys: tuple[str, ...]
    target_critic: bool


def run(args, fam: Family) -> None:
    """The synchronous training loop of DreamerV1 and V2 (the reference's
    `main`s, which differ only where `fam` says), then the test episodes."""
    # fixed by the 4-stage 64x64 conv trunk
    args.screen_size = 64
    args.frame_stack = -1
    device = resolve_device(args.device)
    check_num_devices(args.num_devices, device, args.seq_devices)
    buffer_type = getattr(args, "buffer_type", "sequential").lower()
    if buffer_type not in ("sequential", "episode"):
        raise ValueError(f"unrecognized buffer type {buffer_type!r}: must be `sequential` or `episode`")
    if device.type == "cuda":
        # the reference's float32 products are true float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    noise_gen = torch.Generator(device=device).manual_seed(args.seed)

    envs = make_vector_env(
        [make_dict_env(args.env_id, args.seed + i, rank=0, args=args, vector_env_idx=i)
         for i in range(args.num_envs)],
        sync=args.sync_env or args.num_envs == 1,
    )
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    cnn_keys, mlp_keys = validate_obs_keys(observation_space, args)
    obs_keys = [*cnn_keys, *mlp_keys]
    actions_dim, is_continuous = actions_dim_of(action_space)
    act_sum = int(sum(actions_dim))

    logger, run_dir = create_logger(args, fam.algo)
    telem = Telemetry.from_args(args, run_dir, algo=fam.algo)
    profiler = StepProfiler.from_args(args, run_dir)

    models = fam.build_models(torch.Generator().manual_seed(args.seed), actions_dim, is_continuous, args,
                              observation_space.spaces, cnn_keys, mlp_keys)
    for m in models:
        m.to(device)
    world_model, actor, critic = models[:3]
    maybe_decide_remat(fam.algo, world_model, args, act_sum, telem, store_path=os.path.join(run_dir, "decisions.json"))
    state = fam.state(*models, *fam.make_optimizers(args, world_model, actor, critic))
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
    start_params = {name: [p.detach().clone() for p in getattr(state, name).parameters()]
                    for name in ("world_model", "actor", "critic")}
    player = fam.player(
        world_model.encoder, world_model.rssm, actor, actions_dim=actions_dim,
        stochastic_size=args.stochastic_size, discrete_size=getattr(args, "discrete_size", 0),
        recurrent_state_size=args.recurrent_state_size, is_continuous=is_continuous, compute_dtype=args.precision,
    )
    preprocess = make_device_preprocess(cnn_keys)
    n_envs = args.num_envs
    if args.dry_run:
        # the dry run's one update samples from the two rows it has
        args.per_rank_sequence_length = min(args.per_rank_sequence_length, 2)
    T, B = args.per_rank_sequence_length, args.per_rank_batch_size

    plan = CompilePlan.from_args(args, telem)
    telem.add_gauges(plan.gauges)

    def _train_example():
        data = dreamer_sample_spec(observation_space.spaces, obs_keys, cnn_keys, T, B, act_sum, device, fam.row_keys)
        noise = fam.draw_noise(args, T, B, actions_dim, torch.Generator(device=device).manual_seed(0), device,
                               is_continuous)
        tau = (torch.ones((), device=device),) if fam.target_critic else ()
        return (state, data, *tau, noise)

    train_step = fam.make_train_step(args, cnn_keys, mlp_keys, actions_dim, is_continuous, plan=plan,
                                     example=_train_example)

    def _player_step(player, player_state, obs: dict, uniform, expl):
        with torch.no_grad():
            return player.noisy_step(player_state, preprocess(obs), uniform, expl)

    player_step = plan.register("player_step", _player_step, example=lambda: (
        player, player.init_states(n_envs), dict_obs_spec(observation_space.spaces, obs_keys, cnn_keys, (n_envs,),
                                                          device),
        player.draw_noise(n_envs, torch.Generator(device=device).manual_seed(0), device),
        torch.zeros((), device=device)))

    buffer_size = args.buffer_size // n_envs if not args.dry_run else 4
    memmap_dir = os.path.join(run_dir, "memmap_buffer") if args.memmap_buffer else None
    if buffer_type == "sequential":
        rb = AsyncReplayBuffer(max(buffer_size, T), n_envs, seed=args.seed,
                               **(dict(storage="host", memmap_dir=memmap_dir) if args.memmap_buffer
                                  else dict(storage="device", device=device)))
    else:
        rb = EpisodeBuffer(max(buffer_size, T), sequence_length=T, memmap_dir=memmap_dir, seed=args.seed)
    buffer_ckpt = os.path.abspath(args.checkpoint_path) + "_buffer.npz" if args.checkpoint_path else None
    if buffer_ckpt and args.checkpoint_buffer and os.path.exists(buffer_ckpt) and not args.eval_only:
        rb.load(buffer_ckpt)
        resumed["buffer"] = buffer_ckpt

    single_global_step = n_envs * args.action_repeat
    step_before_training = args.train_every // single_global_step if not args.dry_run else 0
    num_updates = args.total_steps // single_global_step if not args.dry_run else 1
    learning_starts = args.learning_starts // single_global_step if not args.dry_run else 0
    if args.checkpoint_path and not args.checkpoint_buffer:
        learning_starts += start_step
    max_step_expl_decay = args.max_step_expl_decay // args.gradient_steps
    expl_amount = args.expl_amount
    if args.checkpoint_path and max_step_expl_decay > 0:
        expl_amount = polynomial_decay(expl_decay_steps, initial=args.expl_amount, final=args.expl_min,
                                       max_decay_steps=max_step_expl_decay)
    if resumed is not None:
        resumed.update(learning_starts=learning_starts, expl_amount=expl_amount)

    def zero_rows(n: int) -> dict:
        """The scalar columns of an episode's first row: is_first 1, the rest 0."""
        return {k: np.full((n, 1), 1.0 if k == "is_first" else 0.0, np.float32) for k in fam.row_keys}

    # the first row of every env: the reset obs, a zero action and reward
    episode_steps: list[list[dict]] = [[] for _ in range(n_envs)]
    obs = envs.reset(seed=args.seed)[0]
    step_data = {**_host_obs(obs, obs_keys, cnn_keys), "actions": np.zeros((n_envs, act_sum), np.float32),
                 **zero_rows(n_envs)}
    if buffer_type == "sequential":
        rb.add({k: v[None] for k, v in step_data.items()})
    else:
        for i in range(n_envs):
            episode_steps[i].append({k: v[i] for k, v in step_data.items()})
    with torch.inference_mode():
        player_state = player.init_states(n_envs)
    aggregator = MetricAggregator()
    gradient_steps = player_steps = env_steps = 0
    policy_collect_s, step_ms, checkpoints = 0.0, [], []
    plan.start()
    start = time.perf_counter()
    if args.eval_only:
        num_updates = start_step - 1  # no training: straight to the test episodes
    for global_step in range(start_step, num_updates + 1):
        t0 = time.perf_counter()
        telem.mark("rollout")
        if global_step <= learning_starts and not args.checkpoint_path:
            actions = _random_actions(rng, action_space, actions_dim, is_continuous, n_envs)
        else:
            with torch.inference_mode():
                dev_obs = {k: torch.from_numpy(v).to(device) for k, v in _host_obs(obs, obs_keys, cnn_keys).items()}
                player_state, acts = player_step(player, player_state, dev_obs,
                                                 player.draw_noise(n_envs, noise_gen, device),
                                                 torch.full((), float(expl_amount), device=device))
            actions = acts.float().cpu().numpy()
            player_steps += 1

        # a row: the obs the action led to, the action, its reward and done
        if "is_first" in fam.row_keys:
            step_data["is_first"] = step_data["dones"].copy()
        obs, rewards, terms, truncs, infos = envs.step(_env_actions(actions, actions_dim, is_continuous))
        dones = np.logical_or(terms, truncs).astype(np.float32)
        if args.dry_run and buffer_type == "episode":
            dones = np.ones_like(dones)
        for info in infos:
            if "episode" in info:
                aggregator.update("Rewards/rew_avg", float(info["episode"]["r"]))
                aggregator.update("Game/ep_len_avg", float(info["episode"]["l"]))
        env_steps += n_envs
        real_next_obs = _host_obs(obs, obs_keys, cnn_keys)
        for i, info in enumerate(infos):
            if "final_observation" in info:
                for k in obs_keys:
                    real_next_obs[k][i] = info["final_observation"][k]
        step_data.update(real_next_obs)
        step_data["dones"] = dones[:, None]
        step_data["actions"] = actions.astype(np.float32)
        step_data["rewards"] = (np.tanh(rewards) if args.clip_rewards else rewards)[:, None].astype(np.float32)
        if buffer_type == "sequential":
            rb.add({k: v[None] for k, v in step_data.items()})
        else:
            for i in range(n_envs):
                episode_steps[i].append({k: v[i] for k, v in step_data.items()})

        done_idx = np.nonzero(dones)[0].tolist()
        if done_idx:
            reset_data = {**{k: v[done_idx] for k, v in _host_obs(obs, obs_keys, cnn_keys).items()},
                          "actions": np.zeros((len(done_idx), act_sum), np.float32), **zero_rows(len(done_idx))}
            if buffer_type == "episode":
                for col, d in enumerate(done_idx):
                    if len(episode_steps[d]) >= T:
                        rb.add({k: np.stack([s[k] for s in episode_steps[d]]) for k in episode_steps[d][0]})
                    episode_steps[d] = [{k: v[col] for k, v in reset_data.items()}]
            else:
                rb.add({k: v[None] for k, v in reset_data.items()}, done_idx)
            step_data["dones"][done_idx] = 0.0
            mask = torch.zeros(n_envs, device=device)
            mask[done_idx] = 1.0
            with torch.inference_mode():
                player_state = player.reset_states(player_state, mask)
        if global_step > learning_starts:
            policy_collect_s += time.perf_counter() - t0
        step_before_training -= 1

        can_sample = len(rb.buffer) > 0 if buffer_type == "episode" else True
        if global_step >= learning_starts and step_before_training <= 0 and can_sample:
            if fam.target_critic:
                n_samples = args.pretrain_steps if global_step == learning_starts else args.gradient_steps
            else:  # DreamerV1 has no pretraining
                n_samples = args.gradient_steps if not args.dry_run else 1
            telem.mark("buffer/sample")
            if buffer_type == "sequential":
                local = rb.sample(B, sequence_length=T, n_samples=n_samples)
            else:
                local = rb.sample(B, n_samples=n_samples, prioritize_ends=args.prioritize_ends)
            # one copy of the whole sample to the device; each gradient step
            # reads its slice (the plan copies it into the graph's input)
            local = {k: v if torch.is_tensor(v) else torch.from_numpy(v).to(device) for k, v in local.items()}
            telem.mark("train/dispatch")
            t1 = time.perf_counter()
            for i in range(n_samples):
                data = {k: v[i] for k, v in local.items()}
                noise = fam.draw_noise(args, T, B, actions_dim, noise_gen, device, is_continuous)
                tau = ()
                if fam.target_critic:
                    copy = gradient_steps % args.critic_target_network_update_freq == 0
                    tau = (torch.full((), 1.0 if copy else 0.0, device=device),)
                metrics = train_step.device_step(state, data, *tau, noise).clone()
                for name, value in zip(METRICS, metrics):
                    aggregator.update(name, value)
                profiler.tick()
                gradient_steps += 1
            step_before_training = args.train_every // single_global_step
            if args.expl_decay:
                expl_decay_steps += 1
                expl_amount = polynomial_decay(expl_decay_steps, initial=args.expl_amount, final=args.expl_min,
                                               max_decay_steps=max_step_expl_decay)
            aggregator.update("Params/exploration_amount", expl_amount)
            telem.mark("log")
            sps = (global_step - start_step + 1) * single_global_step / (time.perf_counter() - start)
            rec = aggregator.compute()
            aggregator.reset()
            telem.interval(rec, global_step, sps)
            step_ms.extend([(time.perf_counter() - t1) * 1e3 / n_samples] * n_samples)
            rec.update(step=global_step, gradient_steps=gradient_steps, sps=sps)
            logger.record(rec)
            print(f"[{fam.algo}] step {global_step} grad_steps {gradient_steps} "
                  f"rec_loss {rec['Loss/reconstruction_loss']:.4f} policy_loss {rec['Loss/policy_loss']:.4f} "
                  f"value_loss {rec['Loss/value_loss']:.4f}", flush=True)

        if (args.checkpoint_every > 0 and global_step % args.checkpoint_every == 0) or args.dry_run \
                or global_step == num_updates:
            ckpt_path = os.path.join(run_dir, "checkpoints", f"ckpt_{global_step}")
            t_save = time.perf_counter()
            nbytes = save_checkpoint(ckpt_path, checkpoint_state(state, expl_decay_steps, global_step, B), args)
            if args.checkpoint_buffer:
                rb.save(ckpt_path + "_buffer.npz")
            checkpoints.append({"path": ckpt_path, "step": global_step, "bytes": nbytes,
                                "save_ms": (time.perf_counter() - t_save) * 1e3})

    profiler.close()
    envs.close()
    plan.close()
    test_steps: list[int] = []

    def episode() -> float:
        ret, steps = test(player, logger, args, cnn_keys)
        test_steps.append(steps)
        return ret

    t_test = time.perf_counter()
    test_returns = run_test_episodes(episode, args, logger)
    summary = {
        "event": "done", "env_steps": env_steps, "policy_steps": num_updates, "player_steps": player_steps,
        "gradient_steps": gradient_steps, "train_step_ms": step_ms,
        "policy_env_steps_per_s": player_steps * n_envs / policy_collect_s if policy_collect_s > 0 else None,
        "device": str(device), "checkpoints": checkpoints, "resumed": resumed, "buffer_type": buffer_type,
        "test_returns": test_returns, "test_player_steps": test_steps,
        "test_ms": (time.perf_counter() - t_test) * 1e3,
        **_params_delta(start_params, state), "compile": plan.gauges(), "compile_stats": plan.stats(),
        "remat": args.remat, "profile": profiler.trace_path if args.profile else None,
        "vector_env": {"kind": type(envs).__name__, "workers": len(getattr(envs, "processes", ()))},
    }
    telem.close()
    logger.record(summary)
    print(f"[{fam.algo}] done: {gradient_steps} gradient steps, {env_steps} env steps, run dir {run_dir}",
          flush=True)


DREAMER_V2 = Family("dreamer_v2", build_models, DV2TrainState, make_optimizers, PlayerDV2, make_train_step,
                    draw_noise, ROW_KEYS, target_critic=True)


@register_algorithm()
def main(argv: Sequence[str] | None = None) -> None:
    run(parse_run_args(DreamerV2Args, argv), DREAMER_V2)
