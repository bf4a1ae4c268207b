"""PPO, coupled (the port of sheeprl_tpu/algos/ppo/ppo.py), over the port's
host envs or (`--env_backend jax`) its batched envs on the device:

    python -m sheeprl_tpu_torch ppo --env_id CartPole-v1 [--device cpu]
    python -m sheeprl_tpu_torch ppo --env_id CartPole-v1 --env_backend jax [--num_envs 1024]

A rollout of `rollout_steps` policy steps over `num_envs` envs (same-step
autoreset, as a gymnasium vector env does) fills a `ReplayBuffer` on the
device; each step pulls only the env action indices to the host. GAE runs
over the rollout, then `update_epochs` passes of `num_minibatches` Adam
steps over a fresh permutation each. The learning rate, clip and entropy
coefficients anneal linearly when asked. One CPU generator, seeded by
`--seed`, draws each rollout's sampling noise (moved to the device in one
copy) and each epoch's permutation, so the same seed draws the same
numbers on the CPU and on the card, and its state alone makes a resume
continue the run's random stream on any device. Checkpoints
(`ckpt_<update>`, the reference's keys `agent`, `optimizer`,
`update_step`, plus `generator`, that state) are written at
`--checkpoint_every` updates, at `--dry_run` and at the last update;
`--checkpoint_path` resumes at `update_step + 1` (explicit flags override
the checkpoint's config), and `--eval_only` runs no update.
Every run ends with `--test_episodes` greedy episodes, each in a fresh env.

With `--env_backend jax` (the reference's Anakin path, `ppo.py:272-301`,
`:432-465`, `:638-660`) the envs are `envs/device/`'s batched twin of
`--env_id` on the run's device (an id without one raises; there is no
fall back to the host envs), and a whole rollout is one call of
`envs/device/rollout.py:make_ppo_collector`, registered with the plan as
"anakin_rollout": on the card one CUDA graph replay. Its carry (the env
state, the observations, the done flags entering the next step) lives on
the device across updates, updated in place; each rollout's reset states
and action noise are drawn in one go from a generator of their own on the
device, seeded by `--seed`. GAE bootstraps from the carry; the episode
dict is pulled once a rollout; no `ReplayBuffer` is built. A checkpoint
adds the carry (`collector`) and that generator's state
(`collector_generator`), so `--checkpoint_path` resumes the same rollout
stream; the "done" record adds the `Anakin/*` gauges.

The host envs are `utils/env.py:make_dict_env`'s chain (`--mask_vel`,
`--action_repeat`, `--max_episode_steps`, image resize, grayscale and
`--frame_stack`/`--frame_stack_dilation`) in `envs/vector.py`'s vector env,
in worker processes unless `--sync_env` or one env; `--memmap_buffer`
keeps the rollout in host numpy, as the reference's PPO does. Telemetry
(`telemetry.jsonl`, the phase times), the metrics through
`utils/metric.py` and `--profile` (a torch.profiler window over
`--profile_steps` updates) as in the reference.

Not ported: the flock, the non-finite guard, the sanitizer, telemetry
spans and a mesh of more than one device (so no `shard_env_batch`).

Also the two helpers the serving tier and DreamerV3 use:
`validate_obs_keys` and `actions_dim_of`."""

from __future__ import annotations

import os
import time
from typing import Sequence

import numpy as np
import torch

from ...data.buffers import ReplayBuffer
from ...envs import spaces
from ...envs.device import VecDeviceEnv, make_device_env
from ...envs.device.core import tree_load_, tree_state_dict
from ...envs.device.rollout import PPOCollectorCarry, make_ppo_collector
from ...ops.math import gae, normalize, polynomial_decay
from ...compile.plan import CompilePlan
from ...ops.optim import Adam, adam, apply_gradients, load_optimizer_state
from ...parallel.anakin import AnakinStats
from ...utils.checkpoint import load_checkpoint, save_checkpoint
from ...utils.device import check_num_devices, resolve_device
from ...envs.vector import make_vector_env
from ...telemetry.core import Telemetry
from ...utils.env import make_dict_env, obs_zeros
from ...utils.metric import MetricAggregator
from ...utils.profiler import StepProfiler
from ...utils.evaluation import parse_run_args, run_test_episodes
from ...utils.logger import create_logger
from ...utils.registry import register_algorithm
from .agent import (
    PPOAgent, buffer_actions, env_action_indices, indices_to_env_actions, one_hot_to_env_actions,
)
from .args import PPOArgs
from .loss import entropy_loss, policy_loss, value_loss

__all__ = [
    "Rollout", "actions_dim_of", "build_agent", "compute_gae_returns", "flat_batch", "main", "make_optimizer",
    "make_train_step", "policy_step", "rollout_batch", "test", "validate_obs_keys",
]

LOSSES = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss")
ROLLOUT_KEYS = ("actions", "logprobs", "values", "rewards", "dones")


def validate_obs_keys(observation_space: spaces.Dict, args) -> tuple[list, list]:
    """cnn/mlp key validation: with neither given, every 3-D key is a cnn
    key and every 1-D key an mlp key; unknown keys are dropped, and no key
    left at all raises."""
    if args.cnn_keys is None and args.mlp_keys is None:
        args.cnn_keys = [k for k, s in observation_space.spaces.items() if len(s.shape) == 3]
        args.mlp_keys = [k for k, s in observation_space.spaces.items() if len(s.shape) == 1]
    cnn_keys = [k for k in (args.cnn_keys or []) if k in observation_space.spaces]
    mlp_keys = [k for k in (args.mlp_keys or []) if k in observation_space.spaces]
    if not cnn_keys and not mlp_keys:
        raise RuntimeError(
            f"no valid observation keys among cnn={args.cnn_keys} mlp={args.mlp_keys}; "
            f"env provides {sorted(observation_space.spaces)}"
        )
    args.cnn_keys, args.mlp_keys = cnn_keys, mlp_keys
    return cnn_keys, mlp_keys


def actions_dim_of(action_space) -> tuple[list[int], bool]:
    if isinstance(action_space, spaces.Box):
        return [int(np.prod(action_space.shape))], True
    if isinstance(action_space, spaces.Discrete):
        return [int(action_space.n)], False
    if isinstance(action_space, spaces.MultiDiscrete):
        return [int(n) for n in action_space.nvec], False
    raise ValueError(f"unsupported action space {type(action_space)}")


def build_agent(args: PPOArgs, actions_dim: Sequence[int], is_continuous: bool, obs_space: dict,
                cnn_keys: Sequence[str], mlp_keys: Sequence[str], generator: torch.Generator) -> PPOAgent:
    """The agent the config describes, on the CPU."""
    return PPOAgent(
        actions_dim, obs_space, cnn_keys, mlp_keys, cnn_features_dim=args.cnn_features_dim,
        mlp_features_dim=args.mlp_features_dim, screen_size=args.screen_size, mlp_layers=args.mlp_layers,
        dense_units=args.dense_units, dense_act=args.dense_act, layer_norm=args.layer_norm,
        is_continuous=is_continuous, actor_hidden_size=args.actor_hidden_size,
        critic_hidden_size=args.critic_hidden_size, cnn_channels_multiplier=args.cnn_channels_multiplier,
        precision=args.precision, generator=generator,
    )


def make_optimizer(args: PPOArgs, agent: PPOAgent) -> Adam:
    """Adam with the reference's eps (optax `scale_by_adam`, then `-lr`:
    `ops/optim.py:Adam`); the train step clips by global norm before it
    when `max_grad_norm` > 0 and sets the lr of each update."""
    return adam(agent.parameters(), args.lr, args.eps)


@torch.no_grad()
def policy_step(agent: PPOAgent, obs: dict, noise: torch.Tensor):
    """One rollout step, its actions sampled with `noise`
    (`PPOAgent.draw_noise`) -> (actions, logprob, value, env action
    indices), all on the agent's device: the indices are what the host
    pulls."""
    actions, logprob, _, value = agent(obs, noise=noise)
    return actions, logprob, value, env_action_indices(actions, agent.actions_dim, agent.is_continuous)


@torch.no_grad()
def compute_gae_returns(agent: PPOAgent, data: dict, next_obs: dict, next_done: torch.Tensor, gamma: float,
                        gae_lambda: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(returns, advantages) of a `[T, N, 1]` rollout, bootstrapped from the
    value of `next_obs` unless `next_done` ([N, 1])."""
    next_value = agent.get_value(next_obs)
    return gae(data["rewards"], data["values"], data["dones"], next_value, next_done, gamma, gae_lambda)


def _static_batch(step, data: dict) -> dict:
    """`data` copied into the captured minibatch step's own batch tensors,
    which a replay then reads without a copy; `data` itself before the
    capture, on the CPU, or if its shapes differ from the capture's."""
    static = getattr(step, "static_args", lambda: None)()
    if static is None:
        return data
    batch = static[2]
    if batch.keys() != data.keys() or any(batch[k].shape != v.shape or batch[k].dtype != v.dtype
                                          for k, v in data.items()):
        return data
    with torch.no_grad():
        for k, v in data.items():
            batch[k].copy_(v)
    return batch


def make_train_step(args: PPOArgs, num_minibatches: int, plan: CompilePlan | None = None, example=None):
    """The PPO update -> `train_step(agent, optimizer, data, lr, clip_coef,
    ent_coef, generator=None, perms=None) -> metrics`. `data` holds flat
    `[n, ...]` tensors (the observation keys, `actions`, `logprobs`,
    `values`, `returns`, `advantages`). Each of `update_epochs` epochs
    takes `num_minibatches` Adam steps of `n // num_minibatches` rows from
    its permutation, dropping the remainder: `perms` (`[epochs, n]`, the
    reference's own in the parity tests) or `torch.randperm` from
    `generator`. The metrics are the mean of each loss over the steps.

    One Adam step is `train_step.minibatch_step(agent, optimizer, data,
    idx, lr, clip_coef, ent_coef) -> the three losses`: the gather of the
    minibatch's rows by the index tensor, the forward, the gradients, the
    clip and Adam, with `lr`, `clip_coef` and `ent_coef` as device scalars
    (the annealed values a CUDA graph must read at every replay; the
    port's `Adam` reads the lr tensor, another optimizer the update's
    float). With
    `plan` it is registered there as "minibatch_step" (with the `example`
    thunk); once it is captured, each update copies `data` into the
    step's static batch once and passes that, so a replay copies only the
    index and the three scalars. On the host stay the permutations, the
    loops over epochs and minibatches, and one pull of the losses an
    update."""
    obs_keys = (*args.cnn_keys, *args.mlp_keys)

    def loss_fn(agent: PPOAgent, batch: dict, clip_coef: float, ent_coef: float):
        _, new_logprob, entropy, new_value = agent({k: batch[k] for k in obs_keys}, actions=batch["actions"])
        adv = batch["advantages"]
        if args.normalize_advantages:
            adv = normalize(adv)
        pg = policy_loss(new_logprob, batch["logprobs"], adv, clip_coef, args.loss_reduction)
        vf = value_loss(new_value, batch["values"], batch["returns"], clip_coef, args.clip_vloss,
                        args.loss_reduction)
        ent = entropy_loss(entropy, args.loss_reduction)
        return pg + args.vf_coef * vf + ent_coef * ent, torch.stack([pg, vf, ent]).detach()

    def minibatch_step(agent: PPOAgent, optimizer: torch.optim.Optimizer, data: dict, idx: torch.Tensor,
                       lr: torch.Tensor, clip_coef: torch.Tensor, ent_coef: torch.Tensor) -> torch.Tensor:
        for group in optimizer.param_groups:
            if isinstance(optimizer, Adam):
                group["lr"] = lr
        params = list(agent.parameters())
        loss, parts = loss_fn(agent, {k: v[idx] for k, v in data.items()}, clip_coef, ent_coef)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        apply_gradients(params, grads, optimizer, args.max_grad_norm)
        return parts

    step = minibatch_step if plan is None else plan.register("minibatch_step", minibatch_step, example=example,
                                                             role="update")

    def train_step(agent: PPOAgent, optimizer: torch.optim.Optimizer, data: dict, lr: float, clip_coef: float,
                   ent_coef: float, generator: torch.Generator | None = None,
                   perms: torch.Tensor | None = None) -> dict[str, float]:
        n = data["logprobs"].shape[0]
        mb_size = n // num_minibatches
        device = data["logprobs"].device
        scalars = [torch.full((), float(v), device=device) for v in (lr, clip_coef, ent_coef)]
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
        losses, batch = [], data
        for epoch in range(args.update_epochs):
            perm = perms[epoch] if perms is not None else torch.randperm(n, generator=generator)
            idxes = perm[: num_minibatches * mb_size].reshape(num_minibatches, mb_size).to(device)
            for idx in idxes:
                if batch is data:
                    batch = _static_batch(step, data)
                # the step's outputs are a graph's static outputs on the
                # card, overwritten by the next replay
                losses.append(step(agent, optimizer, batch, idx, *scalars).clone())
        for group in optimizer.param_groups:  # a float in the checkpoint, as the reference's
            group["lr"] = float(lr)
        return dict(zip(LOSSES, torch.stack(losses).mean(0).cpu().tolist()))

    train_step.minibatch_step = step
    return train_step


class Rollout:
    """The host side of a run's rollouts: its vector env (`envs/vector.py`,
    reset with `seed`, so env i starts from `seed + i`), the envs' last
    observations, the done flags entering the next step (`next_done`), and
    the (return, length) of the episodes ended since `ended` was last
    cleared (their `RecordEpisodeStatistics`)."""

    def __init__(self, envs, seed: int):
        self.envs = envs
        self.obs = envs.reset(seed=seed)[0]
        self.next_done = np.zeros(envs.num_envs, np.float32)
        self.ended: list[tuple[float, int]] = []

    def device_obs(self, keys: Sequence[str], device) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(self.obs[k]).to(device) for k in keys}

    def collect(self, agent: PPOAgent, rb: ReplayBuffer, obs_keys: Sequence[str],
                generator: torch.Generator, step=policy_step) -> None:
        """`rb.buffer_size` policy steps into `rb`, their sampling noise
        drawn at once from `generator` and moved to the agent's device in
        one copy; each step pulls only the env action indices to the host
        (with host storage also the log-prob and value; the obs and the
        one-hot are rebuilt there). An env whose episode ends resets in the
        same step (the vector env's); a row's `dones` is the done flag
        entering its step.
        `step` is `policy_step` or its graphed twin (`main` registers it);
        its outputs are copied into `rb` before the next step."""
        device = next(agent.parameters()).device
        host = rb.prefers_host_adds
        noise = agent.draw_noise(generator, rb.buffer_size, self.envs.num_envs).to(device)
        for t in range(rb.buffer_size):
            host_obs = {k: self.obs[k] for k in obs_keys}
            obs = {k: torch.from_numpy(v).to(device) for k, v in host_obs.items()}
            actions, logprob, value, env_idx = step(agent, obs, noise[t])
            env_idx = env_idx.cpu().numpy()
            env_actions = indices_to_env_actions(env_idx, agent.actions_dim, agent.is_continuous)
            self.obs, rewards, terms, truncs, infos = self.envs.step(
                [a.item() if np.ndim(a) == 0 else a for a in env_actions])
            dones = np.logical_or(terms, truncs).astype(np.float32)
            self.ended += [(float(info["episode"]["r"]), int(info["episode"]["l"])) for info in infos
                           if "episode" in info]
            rb.add({**{k: v[None] for k, v in (host_obs if host else obs).items()},
                    "actions": buffer_actions(env_idx, actions, agent.actions_dim, agent.is_continuous, host)[None],
                    "logprobs": logprob[None], "values": value[None], "rewards": rewards[None, :, None],
                    "dones": self.next_done[None, :, None]})
            self.next_done = dones


def flat_batch(agent: PPOAgent, traj: dict, next_obs: dict, next_done: torch.Tensor, obs_keys: Sequence[str],
               args: PPOArgs) -> dict[str, torch.Tensor]:
    """The update's flat `[T * N, ...]` batch of a `[T, N, ...]` rollout,
    with its GAE returns and advantages bootstrapped from `next_obs` and
    `next_done` ([N, 1])."""
    data = {k: traj[k] for k in (*obs_keys, *ROLLOUT_KEYS)}
    data["returns"], data["advantages"] = compute_gae_returns(agent, data, next_obs, next_done, args.gamma,
                                                              args.gae_lambda)
    return {k: v.reshape((-1,) + v.shape[2:]) for k, v in data.items() if k not in ("rewards", "dones")}


def rollout_batch(agent: PPOAgent, rb: ReplayBuffer, rollout: Rollout, obs_keys: Sequence[str],
                  args: PPOArgs) -> dict[str, torch.Tensor]:
    """The update's flat `[T * N, ...]` batch of the rollout in `rb`, with
    its GAE returns and advantages bootstrapped from `rollout`'s envs."""
    device = next(agent.parameters()).device
    # host storage (--memmap_buffer) moves the rollout to the agent's device here, in one copy a key
    traj = {k: torch.as_tensor(rb[k], device=device) for k in (*obs_keys, *ROLLOUT_KEYS)}
    return flat_batch(agent, traj, rollout.device_obs(obs_keys, device),
                      torch.from_numpy(rollout.next_done).to(device)[:, None], obs_keys, args)


def test(agent: PPOAgent, env, logger, args: PPOArgs) -> float:
    """One greedy episode in `env` (closed at the end), reset with
    `args.seed`; logs `Test/cumulative_reward`. -> the episode's return."""
    device = next(agent.parameters()).device
    obs, _ = env.reset(seed=args.seed)
    done, cumulative_reward = False, 0.0
    while not done:
        with torch.no_grad():
            actions = agent.get_greedy_actions({k: torch.as_tensor(np.asarray(v)[None], device=device)
                                                for k, v in obs.items()})
        env_actions = one_hot_to_env_actions(actions[0], agent.actions_dim, agent.is_continuous)
        if isinstance(env.action_space, spaces.Discrete):
            env_actions = env_actions.item()
        obs, reward, terminated, truncated, _ = env.step(env_actions)
        done = terminated or truncated
        cumulative_reward += float(reward)
    logger.log("Test/cumulative_reward", cumulative_reward, 0)
    env.close()
    return cumulative_reward


def _set_generator_state(generator: torch.Generator, state: torch.Tensor) -> None:
    """Restore a generator's saved state; a state saved from another kind of
    device (a card's philox state on the CPU, or back) raises."""
    state = state.cpu()
    if state.numel() != generator.get_state().numel():
        raise ValueError(f"the checkpoint's collector generator state was written on another kind of device than "
                         f"{generator.device}; resume it on the device it was written on")
    generator.set_state(state)


@register_algorithm()
def main(argv: Sequence[str] | None = None) -> None:
    args = parse_run_args(PPOArgs, argv)
    device = resolve_device(args.device)
    check_num_devices(args.num_devices, device)
    if device.type == "cuda":
        # the reference's float32 products are true float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    logger, run_dir = create_logger(args, "ppo")

    device_envs = args.env_backend == "jax"
    if device_envs:
        if args.memmap_buffer:
            raise ValueError("--env_backend jax keeps the rollout on the device; drop --memmap_buffer")
        # the Anakin arrangement: the envs beside the agent on the device,
        # a whole rollout one graph replay
        venv = VecDeviceEnv(make_device_env(args.env_id), args.num_envs, device)
        envs, observation_space, action_space = None, venv.single_observation_space, venv.single_action_space
    else:
        envs = make_vector_env(
            [make_dict_env(args.env_id, args.seed + i, rank=0, args=args, vector_env_idx=i,
                           mask_velocities=args.mask_vel) for i in range(args.num_envs)],
            sync=args.sync_env or args.num_envs == 1,
        )
        observation_space, action_space = envs.single_observation_space, envs.single_action_space
    cnn_keys, mlp_keys = validate_obs_keys(observation_space, args)
    obs_keys = [*cnn_keys, *mlp_keys]
    actions_dim, is_continuous = actions_dim_of(action_space)

    agent = build_agent(args, actions_dim, is_continuous, observation_space.spaces, cnn_keys, mlp_keys,
                        torch.Generator().manual_seed(args.seed)).to(device)
    optimizer = make_optimizer(args, agent)
    gen = torch.Generator().manual_seed(args.seed)
    carry = collect_gen = None
    if device_envs:
        # the rollouts' reset states and action noise, drawn on the device
        collect_gen = torch.Generator(device=device).manual_seed(args.seed)
        carry = PPOCollectorCarry.reset(venv, collect_gen)
    start_update, resumed = 1, None
    if args.checkpoint_path:
        ckpt = load_checkpoint(args.checkpoint_path, device)
        agent.load_state_dict(ckpt["agent"])
        load_optimizer_state(optimizer, ckpt["optimizer"])
        gen.set_state(ckpt["generator"].cpu())
        if device_envs and "collector" in ckpt:
            # the same rollout stream the uninterrupted run would collect
            tree_load_(carry, ckpt["collector"])
            _set_generator_state(collect_gen, ckpt["collector_generator"])
        start_update = int(ckpt["update_step"]) + 1
        resumed = {"checkpoint": os.path.abspath(args.checkpoint_path), "start_update": start_update}
        del ckpt

    n_envs = args.num_envs
    rollout_size = args.rollout_steps * n_envs
    # a dry run takes exactly one update, also after a resume
    num_updates = args.total_steps // rollout_size if not args.dry_run else start_update
    num_minibatches = max(rollout_size // args.per_rank_batch_size, 1)
    # the rollout store on the device, or (--memmap_buffer, as the
    # reference's PPO reads it) in host numpy
    rb = None if device_envs else ReplayBuffer(args.rollout_steps, n_envs,
                                               storage="host" if args.memmap_buffer else "device", device=device,
                                               obs_keys=obs_keys, seed=args.seed)

    telem = Telemetry.from_args(args, run_dir, algo="ppo")
    profiler = StepProfiler.from_args(args, run_dir)
    aggregator = MetricAggregator()
    # the policy step and the minibatch step as CUDA graphs on the card
    # (compile/plan.py), with example arguments of their shapes for
    # --warm_compile on
    plan = CompilePlan.from_args(args, telem)
    telem.add_gauges(plan.gauges)

    def _obs(lead: tuple) -> dict:
        return obs_zeros(observation_space.spaces, obs_keys, lead, device)

    def _minibatch_example():
        data = {**_obs((rollout_size,)), "actions": torch.zeros((rollout_size, int(sum(actions_dim))), device=device),
                **{k: torch.zeros((rollout_size, 1), device=device)
                   for k in ("logprobs", "values", "returns", "advantages")}}
        idx = torch.zeros((rollout_size // num_minibatches,), dtype=torch.int64, device=device)
        return (agent, optimizer, data, idx, *(torch.full((), v, device=device)
                                               for v in (args.lr, args.clip_coef, args.ent_coef)))

    train_step = make_train_step(args, num_minibatches, plan=plan, example=_minibatch_example)
    anakin = rollout = None
    if device_envs:
        def _draws(generator: torch.Generator) -> tuple:
            return venv.draw_resets(generator, args.rollout_steps), agent.draw_noise(generator, args.rollout_steps,
                                                                                    n_envs)

        # one replay is one whole rollout; the graph reads and writes the
        # carry's own tensors (adopt)
        collect = plan.register(
            "anakin_rollout", make_ppo_collector(venv, args.rollout_steps, actions_dim, is_continuous),
            example=lambda: (agent, carry, *_draws(torch.Generator(device=device).manual_seed(0))), adopt=True)
        anakin = AnakinStats(scan_span=args.rollout_steps, env_batch=n_envs, devices=1)
    else:
        graphed_policy_step = plan.register("policy_step", policy_step, example=lambda: (
            agent, _obs((n_envs,)), agent.draw_noise(torch.Generator(device=device), n_envs)))
        rollout = Rollout(envs, args.seed)
    rollout_ms, train_ms, checkpoints = [], [], []
    env_steps = 0
    plan.start()
    start = time.perf_counter()
    if args.eval_only:
        num_updates = start_update - 1  # no update: straight to the test episodes
    for update in range(start_update, num_updates + 1):
        lr, clip_coef, ent_coef = (
            polynomial_decay(update, initial=value, final=0.0, max_decay_steps=num_updates) if anneal else value
            for value, anneal in ((args.lr, args.anneal_lr), (args.clip_coef, args.anneal_clip_coef),
                                  (args.ent_coef, args.anneal_ent_coef))
        )
        t0 = time.perf_counter()
        telem.mark("rollout")
        if device_envs:
            traj, ep = collect(agent, carry, *_draws(collect_gen))
            # the one pull of a rollout: the episode dict (the device has
            # retired the rollout when it lands)
            episodes, return_sum, length_sum = torch.stack(
                [ep["episodes"], ep["return_sum"], ep["length_sum"]]).tolist()
            if episodes > 0:
                aggregator.update("Rewards/rew_avg", return_sum / episodes)
                aggregator.update("Game/ep_len_avg", length_sum / episodes)
        else:
            rollout.collect(agent, rb, obs_keys, gen, step=graphed_policy_step)
            for ret, length in rollout.ended:
                aggregator.update("Rewards/rew_avg", ret)
                aggregator.update("Game/ep_len_avg", length)
            rollout.ended.clear()
        env_steps += rollout_size
        t1 = time.perf_counter()
        telem.mark("train/dispatch")
        if device_envs:
            anakin.note(rollout_size, t1 - t0)
            batch = flat_batch(agent, traj, carry.obs, carry.prev_done, obs_keys, args)
        else:
            batch = rollout_batch(agent, rb, rollout, obs_keys, args)
        metrics = train_step(agent, optimizer, batch, lr, clip_coef, ent_coef, generator=gen)
        profiler.tick()
        t2 = time.perf_counter()
        rollout_ms.append((t1 - t0) * 1e3)
        train_ms.append((t2 - t1) * 1e3)

        telem.mark("log")
        for name, value in metrics.items():
            aggregator.update(name, value)
        aggregator.update("Info/learning_rate", lr)
        sps = env_steps / (time.perf_counter() - start)
        rec = aggregator.compute()
        aggregator.reset()
        telem.interval(rec, update * rollout_size, sps)
        rec.update({"update": update, "step": update * rollout_size, "Time/rollout_ms": rollout_ms[-1],
                    "Time/train_ms": train_ms[-1], "Time/step_per_second": sps})
        logger.record(rec)
        print(f"[ppo] update {update}/{num_updates} " + " ".join(
            f"{k.split('/')[1]} {rec[k]:.4g}" for k in (*LOSSES, "Rewards/rew_avg") if k in rec), flush=True)

        if (args.checkpoint_every > 0 and update % args.checkpoint_every == 0) or args.dry_run \
                or update == num_updates:
            ckpt_path = os.path.join(run_dir, "checkpoints", f"ckpt_{update}")
            t_save = time.perf_counter()
            saved = {"agent": agent.state_dict(), "optimizer": optimizer.state_dict(), "update_step": update,
                     "generator": gen.get_state()}
            if device_envs:  # the rollout stream's position: the carry and its draws' generator
                saved.update(collector=tree_state_dict(carry), collector_generator=collect_gen.get_state())
            nbytes = save_checkpoint(ckpt_path, saved, args)
            checkpoints.append({"path": ckpt_path, "update": update, "bytes": nbytes,
                                "save_ms": (time.perf_counter() - t_save) * 1e3})
    profiler.close()
    if envs is not None:
        envs.close()
    plan.close()

    t_test = time.perf_counter()
    test_returns = run_test_episodes(
        lambda: test(agent, make_dict_env(args.env_id, args.seed, rank=0, args=args, prefix="test")(), logger,
                     args),
        args, logger,
    )
    logger.record({
        "event": "done", "updates": len(train_ms), "env_steps": env_steps, "rollout_ms": rollout_ms,
        "train_ms": train_ms, "env_steps_per_s": env_steps / max(sum(rollout_ms) + sum(train_ms), 1e-9) * 1e3,
        "device": str(device), "checkpoints": checkpoints, "resumed": resumed, "test_returns": test_returns,
        "test_ms": (time.perf_counter() - t_test) * 1e3, "compile": plan.gauges(), "compile_stats": plan.stats(),
        "env_backend": args.env_backend, "anakin": anakin.gauges() if anakin is not None else None,
        "profile": profiler.trace_path if args.profile else None,
    })
    telem.close()
    print(f"[ppo] done: {len(train_ms)} updates, {env_steps} env steps, test returns {test_returns}, "
          f"run dir {run_dir}", flush=True)
