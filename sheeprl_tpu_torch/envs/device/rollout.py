"""The Anakin collectors (the port of sheeprl_tpu/envs/jax/rollout.py).

Podracer's Anakin arrangement (arXiv:2104.06272) puts the envs beside the
agent on the device, so a whole rollout is `policy -> env.step` over T
steps with no host round trip. The reference writes it as one `lax.scan`
under `jax.jit`; here a collector is a plain Python loop over T steps that
`compile/plan.py` captures as one CUDA graph, so one replay is one whole
rollout (PPO) or one collection chunk (DreamerV3). What a graph needs,
the collectors keep:

- the carry (env state, observations, the done flag entering the next
  step, DreamerV3's host-shifted reward and `is_first`, and the player's
  recurrent state) is updated in place at the end of each call, so its
  tensors survive across replays (`tree_copy_`); register a collector
  with `adopt=True` and the graph reads and writes the caller's carry;
- every draw is made outside, in one go, and passed in: the fresh reset
  states of T steps (`VecDeviceEnv.draw_resets`), PPO's action noise
  (`PPOAgent.draw_noise`, `[T, N, A]`), the player's uniforms
  (`PlayerDV3.noisy_step`'s layout, `[T, N, noise_width]`) or the random
  phase's actions (`random_action_sampler`, one draw);
- the trajectory and the episode dict are a replay's static outputs: the
  caller consumes them (GAE, `add_direct`, one pull of the episode dict)
  before the next replay overwrites them.

Two collectors share the loop:

- `make_ppo_collector`: rows in PPO's rollout layout (`obs keys...,
  actions` (one-hot, or raw values), `logprobs`, `values`, `rewards`,
  `dones` = the done flag entering the step), `[T, N, ...]`, which the
  GAE and the update read unchanged;
- `make_dreamer_collector`: rows in the DreamerV3 ring layout (`obs
  keys..., actions, rewards, dones, is_first`) with the host-shifted
  alignment (the reward and done of step t-1 ride row t), ready for
  `AsyncReplayBuffer.reserve` / `add_direct`. An episode boundary is one
  row: the auto-reset row carries the terminal reward and done beside
  `is_first = 1` (`howto/jax_envs.md`, "Semantics"), where the host path
  writes a terminal row of its own.

Both return an episode dict of device scalars (`episodes`, `return_sum`,
`length_sum`): one pull a rollout replaces the host loop's per-step
bookkeeping.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .core import VecDeviceEnv, VecEnvState, tree_copy_, tree_index

__all__ = [
    "DreamerCollectorCarry", "PPOCollectorCarry", "env_native_actions", "episode_summary",
    "make_dreamer_collector", "make_ppo_collector", "random_action_sampler",
]


@dataclass
class PPOCollectorCarry:
    """What PPO's rollout threads between steps, and between rollouts (the
    carry survives across updates, as the host loop's obs and done flags
    do)."""

    vec: VecEnvState
    obs: dict  # {key: [N, ...]}
    prev_done: torch.Tensor  # [N, 1] f32: the done flag entering the next step

    @classmethod
    def reset(cls, venv: VecDeviceEnv, generator: torch.Generator) -> "PPOCollectorCarry":
        """Every env reset from one draw; no env done."""
        vec, obs = venv.reset(generator)
        return cls(vec=vec, obs=obs, prev_done=torch.zeros((venv.num_envs, 1), device=venv.device))


@dataclass
class DreamerCollectorCarry:
    vec: VecEnvState
    obs: dict  # {key: [N, ...]} raw (uint8 pixels)
    prev_reward: torch.Tensor  # [N, 1] f32 (host-shifted row alignment)
    prev_done: torch.Tensor  # [N, 1] f32
    is_first: torch.Tensor  # [N, 1] f32

    @classmethod
    def reset(cls, venv: VecDeviceEnv, generator: torch.Generator) -> "DreamerCollectorCarry":
        """Every env reset from one draw: the first row of each env is an
        `is_first` row with reward and done 0."""
        vec, obs = venv.reset(generator)
        n, dev = venv.num_envs, venv.device
        return cls(vec=vec, obs=obs, prev_reward=torch.zeros((n, 1), device=dev),
                   prev_done=torch.zeros((n, 1), device=dev), is_first=torch.ones((n, 1), device=dev))


def episode_summary(done_f: torch.Tensor, ep_return: torch.Tensor, ep_length: torch.Tensor) -> dict:
    """The `[T, N]` done flags and episode stats of a rollout reduced to the
    three scalars logging needs (one pull a rollout)."""
    return {"episodes": done_f.sum(), "return_sum": (ep_return * done_f).sum(),
            "length_sum": (ep_length * done_f).sum()}


def env_native_actions(actions: torch.Tensor, actions_dim: Sequence[int], is_continuous: bool) -> torch.Tensor:
    """The agent's actions in the env-native layout: `int32 [N]` (the argmax)
    for one discrete head, `[N, heads]` for several, raw values for
    continuous actions."""
    if is_continuous:
        return actions
    heads = torch.split(actions, list(actions_dim), dim=-1)
    idx = torch.stack([h.argmax(-1) for h in heads], dim=-1).to(torch.int32)
    return idx[..., 0] if len(actions_dim) == 1 else idx


def random_action_sampler(action_space, actions_dim: Sequence[int], is_continuous: bool) -> Callable:
    """The device's twin of the host's `action_space.sample()` warm-up:
    `sample(generator, *lead) -> [*lead, sum(actions_dim)]` from one draw on
    the generator's device: one-hot a discrete head, uniform in the box for
    continuous actions."""
    if is_continuous:
        shape = tuple(action_space.shape)
        low = np.broadcast_to(np.asarray(action_space.low, np.float32), shape).reshape(-1)
        high = np.broadcast_to(np.asarray(action_space.high, np.float32), shape).reshape(-1)

        def sample(generator: torch.Generator, *lead: int) -> torch.Tensor:
            dev = generator.device
            lo, hi = torch.from_numpy(low.copy()).to(dev), torch.from_numpy(high.copy()).to(dev)
            return lo + torch.rand((*lead, lo.numel()), generator=generator, device=dev) * (hi - lo)

        return sample
    dims = tuple(int(d) for d in actions_dim)

    def sample(generator: torch.Generator, *lead: int) -> torch.Tensor:
        u = torch.rand((*lead, len(dims)), generator=generator, device=generator.device)
        hots = [torch.nn.functional.one_hot((u[..., i] * d).long().clamp_max(d - 1), d).float()
                for i, d in enumerate(dims)]
        return torch.cat(hots, dim=-1)

    return sample


def _stack_rows(rows: list[dict]) -> dict:
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def make_ppo_collector(venv: VecDeviceEnv, rollout_steps: int, actions_dim: Sequence[int],
                       is_continuous: bool) -> Callable:
    """-> `collect(agent, carry, fresh, noise) -> (traj, ep)`: `rollout_steps`
    policy steps of every env from `carry` (updated in place), with `fresh`
    the rollout's reset states (`venv.draw_resets(generator, T)`) and
    `noise` its action noise (`agent.draw_noise(generator, T, N)`). `traj`
    is `[T, N, ...]` in PPO's rollout layout, `ep` the episode dict.
    Register it with the plan (`adopt=True`): one replay is one rollout."""

    def collect(agent, carry: PPOCollectorCarry, fresh: Any, noise: torch.Tensor):
        with torch.no_grad():
            vec, obs, prev_done = carry.vec, carry.obs, carry.prev_done
            rows, dones, returns, lengths = [], [], [], []
            for t in range(rollout_steps):
                actions, logprob, _, value = agent(obs, noise=noise[t])
                env_actions = env_native_actions(actions, actions_dim, is_continuous)
                vec, next_obs, reward, done, info = venv.step(vec, env_actions, tree_index(fresh, t))
                rows.append({**obs, "actions": actions, "logprobs": logprob, "values": value,
                             "rewards": reward[:, None], "dones": prev_done})
                done_f = done.to(torch.float32)
                dones.append(done_f)
                returns.append(info["ep_return"])
                lengths.append(info["ep_length"].to(torch.float32))
                obs, prev_done = next_obs, done_f[:, None]
            traj = _stack_rows(rows)
            ep = episode_summary(torch.stack(dones), torch.stack(returns), torch.stack(lengths))
            tree_copy_(carry, PPOCollectorCarry(vec=vec, obs=obs, prev_done=prev_done))
        return traj, ep

    return collect


def make_dreamer_collector(venv: VecDeviceEnv, steps: int, actions_dim: Sequence[int], is_continuous: bool,
                           preprocess: Callable, clip_rewards: bool = False, random_actions: bool = False) -> Callable:
    """-> `collect(player, player_state, carry, fresh, draws, expl) -> (traj,
    ep)`: `steps` steps of every env in the DreamerV3 ring layout
    `[steps, N, ...]`, ready for `rb.reserve(steps)` + `rb.add_direct`.
    `fresh` holds the chunk's reset states; `draws` is the player's
    uniforms (`[steps, N, player.noise_width()]`, `noisy_step`'s layout)
    and `expl` the exploration amount (a device scalar), or with
    `random_actions` the chunk's actions (`random_action_sampler`, `[steps,
    N, A]`), and then the player and its state are left untouched (the
    learning-starts warm-up). `carry` and `player_state` are updated in
    place; a player's rows are reset where an env is done
    (`player.reset_states`)."""

    def collect(player, player_state, carry: DreamerCollectorCarry, fresh: Any, draws: torch.Tensor,
                expl: torch.Tensor):
        with torch.no_grad():
            pstate, vec, obs = player_state, carry.vec, carry.obs
            prev_reward, prev_done, is_first = carry.prev_reward, carry.prev_done, carry.is_first
            rows, dones, returns, lengths = [], [], [], []
            for t in range(steps):
                if random_actions:
                    actions = draws[t]
                else:
                    pstate, actions = player.noisy_step(pstate, preprocess(obs), draws[t], expl)
                actions = actions.to(torch.float32)
                rows.append({**obs, "actions": actions, "rewards": prev_reward, "dones": prev_done,
                             "is_first": is_first})
                env_actions = env_native_actions(actions, actions_dim, is_continuous)
                vec, obs, reward, done, info = venv.step(vec, env_actions, tree_index(fresh, t))
                if clip_rewards:
                    reward = torch.tanh(reward)
                done_f = done.to(torch.float32)[:, None]
                if not random_actions:
                    pstate = player.reset_states(pstate, done_f[:, 0])
                dones.append(done_f[:, 0])
                returns.append(info["ep_return"])
                lengths.append(info["ep_length"].to(torch.float32))
                # the next row's host-shifted fields: this step's reward and
                # done land on the auto-reset row beside its is_first flag
                prev_reward, prev_done, is_first = reward[:, None], done_f, done_f
            traj = _stack_rows(rows)
            ep = episode_summary(torch.stack(dones), torch.stack(returns), torch.stack(lengths))
            if not random_actions:
                tree_copy_(player_state, pstate)
            tree_copy_(carry, DreamerCollectorCarry(vec=vec, obs=obs, prev_reward=prev_reward, prev_done=prev_done,
                                                    is_first=is_first))
        return traj, ep

    return collect
