"""Deterministic dummy envs (the port of sheeprl_tpu/envs/dummy.py):
channel-LAST `[H, W, C]` uint8 image observations."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import spaces


class _DummyBase:
    def __init__(self, size: tuple[int, int, int] = (64, 64, 3), n_steps: int = 4):
        self.observation_space = spaces.Box(0, 255, shape=size, dtype=np.uint8)
        self._current_step = 0
        self._n_steps = n_steps
        self._rng = np.random.default_rng(0)

    def _obs(self) -> np.ndarray:
        return self._rng.integers(0, 256, self.observation_space.shape, dtype=np.uint8)

    def step(self, action):
        done = self._current_step == self._n_steps
        self._current_step += 1
        return self._obs(), 0.0, done, False, {}

    def reset(self, seed=None, options=None):
        self._current_step = 0
        return np.zeros(self.observation_space.shape, dtype=np.uint8), {}

    def close(self):
        pass


class ContinuousDummyEnv(_DummyBase):
    def __init__(self, action_dim: int = 2, size=(64, 64, 3), n_steps: int = 4):
        super().__init__(size, n_steps)
        self.action_space = spaces.Box(-np.inf, np.inf, shape=(action_dim,))


class DiscreteDummyEnv(_DummyBase):
    def __init__(self, action_dim: int = 2, size=(64, 64, 3), n_steps: int = 4):
        super().__init__(size, n_steps)
        self.action_space = spaces.Discrete(action_dim)


class MultiDiscreteDummyEnv(_DummyBase):
    def __init__(self, action_dims: Sequence[int] = (2, 2), size=(64, 64, 3), n_steps: int = 4):
        super().__init__(size, n_steps)
        self.action_space = spaces.MultiDiscrete(list(action_dims))
