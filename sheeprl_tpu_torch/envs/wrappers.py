"""Environment wrappers (the port of sheeprl_tpu/envs/wrappers.py) without
gymnasium.

Images are channel-last `[H, W, C]` uint8, as in the reference, and
`FrameStack` concatenates along the channel axis -> `[H, W, C * num_stack]`.
`Wrapper` is the small base the port's envs share: it forwards `reset`,
`step`, `close` and any attribute it does not define to the env it wraps.
`TimeLimit` and `RecordEpisodeStatistics` are written here because the
reference takes them from gymnasium (`gym.wrappers`), with gymnasium's
semantics: the limit truncates the step that reaches it, and the episode's
return, length and wall time land in the last step's `info["episode"]`.

`MaskVelocityWrapper` keys on the env id, which the reference reads from the
env's gymnasium `spec`; the port's envs have none, so the id is passed in.
The reference's `RestartOnException` comes with the resilience services
(ROADMAP Queue A item 9).
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Sequence

import numpy as np

from . import spaces

__all__ = [
    "ActionRepeat",
    "DictObservation",
    "FrameStack",
    "MaskVelocityWrapper",
    "ObservationWrapper",
    "RecordEpisodeStatistics",
    "StepLatencyWrapper",
    "TimeLimit",
    "Wrapper",
    "maybe_step_latency",
]


class Wrapper:
    """Forward the env API to `env`; a wrapper overrides what it changes."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        return self.env.step(action)

    def close(self):
        self.env.close()

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def __getattr__(self, name: str):
        # only reached for names this wrapper lacks; `env` itself must exist
        # (a half-built wrapper has no `env` to forward to)
        if name.startswith("_") or name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)


class ObservationWrapper(Wrapper):
    def observation(self, observation):
        raise NotImplementedError

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.observation(obs), reward, terminated, truncated, info


class StepLatencyWrapper(Wrapper):
    """A real-time environment: every `step()` pays a fixed wall-clock
    latency without using the CPU (`time.sleep`)."""

    def __init__(self, env, latency_ms: float):
        super().__init__(env)
        self._latency_s = float(latency_ms) / 1000.0

    def step(self, action):
        time.sleep(self._latency_s)
        return self.env.step(action)


def maybe_step_latency(env):
    """`StepLatencyWrapper` when SHEEPRL_TPU_ENV_LATENCY_MS is set above 0."""
    ms = os.environ.get("SHEEPRL_TPU_ENV_LATENCY_MS")
    try:
        ms_f = float(ms) if ms else 0.0
    except ValueError:
        ms_f = 0.0
    return StepLatencyWrapper(env, ms_f) if ms_f > 0 else env


class MaskVelocityWrapper(ObservationWrapper):
    """Zero the velocity entries of a classic-control observation, which
    makes the task partially observable."""

    velocity_indices: dict[str, np.ndarray] = {
        "CartPole-v0": np.array([1, 3]),
        "CartPole-v1": np.array([1, 3]),
        "MountainCar-v0": np.array([1]),
        "MountainCarContinuous-v0": np.array([1]),
        "Pendulum-v1": np.array([2]),
        "LunarLander-v2": np.array([2, 3, 5]),
        "LunarLanderContinuous-v2": np.array([2, 3, 5]),
    }

    def __init__(self, env, env_id: str):
        super().__init__(env)
        space = env.observation_space
        self.mask = np.ones(space.shape, dtype=space.dtype)
        try:
            self.mask[self.velocity_indices[env_id]] = 0.0
        except KeyError as e:
            raise NotImplementedError(f"velocity masking not implemented for {env_id}") from e

    def observation(self, observation: np.ndarray) -> np.ndarray:
        return observation * self.mask


class ActionRepeat(Wrapper):
    """Repeat an action `amount` times, summing the rewards and stopping at
    the episode's end; the info is the last inner step's."""

    def __init__(self, env, amount: int = 1):
        super().__init__(env)
        if amount <= 0:
            raise ValueError("`amount` must be a positive integer")
        self._amount = amount

    @property
    def action_repeat(self) -> int:
        return self._amount

    def step(self, action):
        total_reward, terminated, truncated = 0.0, False, False
        obs, info = None, {}
        for _ in range(self._amount):
            obs, reward, terminated, truncated, info = self.env.step(action)
            total_reward += float(reward)
            if terminated or truncated:
                break
        return obs, total_reward, terminated, truncated, info


class FrameStack(Wrapper):
    """Stack the last `num_stack` frames of each image key along the channel
    axis (`[H, W, C] -> [H, W, C * num_stack]`), every `dilation`-th frame
    of the last `num_stack * dilation`; a reset fills the window with the
    reset frame."""

    def __init__(self, env, num_stack: int, cnn_keys: Sequence[str], dilation: int = 1):
        super().__init__(env)
        if num_stack <= 0:
            raise ValueError(f"num_stack must be > 0, got {num_stack}")
        if dilation <= 0:
            raise ValueError(f"dilation must be > 0, got {dilation}")
        if not isinstance(env.observation_space, spaces.Dict):
            raise RuntimeError(f"expected a Dict observation space, got {type(env.observation_space)}")
        self._num_stack = num_stack
        self._dilation = dilation
        self._cnn_keys = [k for k, v in env.observation_space.spaces.items() if k in cnn_keys and len(v.shape) == 3]
        if not self._cnn_keys:
            raise RuntimeError("specify at least one valid cnn key to stack")
        stacked = dict(env.observation_space.spaces)
        for k in self._cnn_keys:
            sp = stacked[k]
            h, w, c = sp.shape

            def tile(bound):
                return bound if np.ndim(bound) == 0 else np.concatenate([bound] * num_stack, axis=-1)

            stacked[k] = spaces.Box(tile(sp.low), tile(sp.high), (h, w, c * num_stack), sp.dtype)
        self.observation_space = spaces.Dict(stacked)
        self._frames = {k: deque(maxlen=num_stack * dilation) for k in self._cnn_keys}

    def _stacked(self, key: str) -> np.ndarray:
        frames = list(self._frames[key])[self._dilation - 1::self._dilation]
        if len(frames) != self._num_stack:
            raise RuntimeError(f"{len(frames)} frames in the window of {key!r}, {self._num_stack} expected")
        return np.concatenate(frames, axis=-1)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        for k in self._cnn_keys:
            self._frames[k].append(obs[k])
            obs[k] = self._stacked(k)
        return obs, reward, terminated, truncated, info

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        for k in self._cnn_keys:
            self._frames[k].clear()
            for _ in range(self._num_stack * self._dilation):
                self._frames[k].append(obs[k])
            obs[k] = self._stacked(k)
        return obs, info


class DictObservation(ObservationWrapper):
    """Expose a Box-observation env as a one-key dict-observation env."""

    def __init__(self, env, key: str):
        super().__init__(env)
        self.key = key
        self.observation_space = spaces.Dict({key: env.observation_space})

    def observation(self, observation):
        return {self.key: observation}


class TimeLimit(Wrapper):
    """Truncate an episode at its `max_episode_steps`-th step (gymnasium's
    `TimeLimit`)."""

    def __init__(self, env, max_episode_steps: int):
        super().__init__(env)
        if max_episode_steps <= 0:
            raise ValueError(f"max_episode_steps must be > 0, got {max_episode_steps}")
        self._max_episode_steps = int(max_episode_steps)
        self._elapsed_steps = 0

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self._max_episode_steps:
            truncated = True
        return obs, reward, terminated, truncated, info

    def reset(self, seed=None, options=None):
        self._elapsed_steps = 0
        return self.env.reset(seed=seed, options=options)


class RecordEpisodeStatistics(Wrapper):
    """At an episode's last step, `info["episode"] = {"r": return, "l":
    length, "t": seconds}` (gymnasium's `RecordEpisodeStatistics`)."""

    def __init__(self, env):
        super().__init__(env)
        self._return, self._length, self._t0 = 0.0, 0, time.perf_counter()

    def reset(self, seed=None, options=None):
        self._return, self._length, self._t0 = 0.0, 0, time.perf_counter()
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._return += float(reward)
        self._length += 1
        if terminated or truncated:
            if "episode" in info:
                raise ValueError("info already holds an 'episode' key")
            info = dict(info)
            info["episode"] = {"r": self._return, "l": self._length,
                               "t": round(time.perf_counter() - self._t0, 6)}
        return obs, reward, terminated, truncated, info
