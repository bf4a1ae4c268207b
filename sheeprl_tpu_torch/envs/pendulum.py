"""Pendulum-v1 without gymnasium (the port of
sheeprl_tpu/envs/jax/pendulum.py:40-88).

The reference's JAX Pendulum: gymnasium's torque-limited swing-up ODE, cost
and reset distribution in float32, the registered spec's 200-step
`TimeLimit` truncation folded into a step counter; the env never
terminates. One env is stepped on the host, as `envs/cartpole.py` steps
CartPole. Its observation is the [3] float32 vector (cos theta, sin theta,
theta_dot), its action a [1] torque in [-2, 2]. A reset draws (theta,
theta_dot) uniform in [-pi, pi] x [-1, 1] from a numpy generator seeded by
the env's seed (the reference draws from a `jax.random` key, so the two
start from different states for the same seed).
"""

from __future__ import annotations

import numpy as np

from . import spaces

__all__ = ["Pendulum"]

# each constant rounded once to float32, as the reference's Python-float
# constants meet its float32 arrays
_F32 = np.float32
_MAX_SPEED = _F32(8.0)
_MAX_TORQUE = _F32(2.0)
_DT = _F32(0.05)
_G = 10.0
_M = 1.0
_L = 1.0
_PI = _F32(np.pi)
_TWO_PI = _F32(2 * np.pi)
_GRAVITY_TERM = _F32(3 * _G / (2 * _L))
_TORQUE_TERM = _F32(3.0 / (_M * _L**2))
_RESET_HIGH = np.array([np.pi, 1.0], dtype=np.float32)


def _angle_normalize(x):
    return ((x + _PI) % _TWO_PI) - _PI


class Pendulum:
    """One Pendulum env: observations [3] float32, actions [1] float32."""

    max_episode_steps = 200

    def __init__(self, seed: int = 0):
        high = np.array([1.0, 1.0, _MAX_SPEED], dtype=np.float32)
        self.observation_space = spaces.Box(-high, high, (3,), np.float32)
        self.action_space = spaces.Box(-_MAX_TORQUE, _MAX_TORQUE, (1,), np.float32)
        self._rng = np.random.default_rng(seed)
        self.state = np.zeros(2, np.float32)
        self.t = 0

    @staticmethod
    def _obs(state: np.ndarray) -> np.ndarray:
        th, thdot = state
        return np.array([np.cos(th), np.sin(th), thdot], dtype=np.float32)

    def reset(self, seed: int | None = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(-1.0, 1.0, 2).astype(np.float32) * _RESET_HIGH
        self.t = 0
        return self._obs(self.state), {}

    def step(self, action):
        th, thdot = (_F32(v) for v in self.state)
        u = np.clip(_F32(np.asarray(action, np.float32).reshape(())), -_MAX_TORQUE, _MAX_TORQUE)
        costs = _angle_normalize(th) ** 2 + _F32(0.1) * thdot**2 + _F32(0.001) * u**2
        newthdot = thdot + (_GRAVITY_TERM * np.sin(th) + _TORQUE_TERM * u) * _DT
        newthdot = np.clip(newthdot, -_MAX_SPEED, _MAX_SPEED)
        newth = th + newthdot * _DT
        self.state = np.array([newth, newthdot], dtype=np.float32)
        self.t += 1
        truncated = self.t >= self.max_episode_steps
        return self._obs(self.state), float(-costs), False, truncated, {}

    def close(self):
        pass
