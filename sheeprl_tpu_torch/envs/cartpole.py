"""CartPole-v1 without gymnasium (the port of sheeprl_tpu/envs/jax/cartpole.py).

The reference's JAX CartPole: the same Euler-integrated cart-pole ODE,
constants and termination thresholds as gymnasium's `CartPole-v1`, the
500-step `TimeLimit` truncation folded into a step counter, float32
arithmetic, reward 1.0 a step. One env is stepped on the host, as the
reference's `JaxEnvGymWrapper` steps a JAX env; its observation is the
[4] float32 vector (x, x_dot, theta, theta_dot), which
`utils/env.py:make_dict_env` exposes under the first mlp key. A reset
draws the state uniform in +-0.05 from a numpy generator seeded by the
env's seed (the reference draws from a `jax.random` key, so the two start
from different states for the same seed).
"""

from __future__ import annotations

import numpy as np

from . import spaces

__all__ = ["CartPole"]

# each constant computed in float64, then rounded once to float32 (as the
# reference's Python-float constants meet its float32 arrays)
_F32 = np.float32
_GRAVITY = _F32(9.8)
_MASSPOLE = _F32(0.1)
_TOTAL_MASS = _F32(0.1 + 1.0)
_LENGTH = _F32(0.5)  # half the pole's length
_POLEMASS_LENGTH = _F32(0.1 * 0.5)
_FORCE_MAG = _F32(10.0)
_TAU = _F32(0.02)
_FOUR_THIRDS = _F32(4.0 / 3.0)
_THETA_THRESHOLD = _F32(12 * 2 * np.pi / 360)
_X_THRESHOLD = _F32(2.4)


class CartPole:
    """One CartPole env: observations [4] float32, actions 0 (push left) and
    1 (push right)."""

    max_episode_steps = 500

    def __init__(self, seed: int = 0):
        high = np.array([_X_THRESHOLD * 2, np.inf, _THETA_THRESHOLD * 2, np.inf], dtype=np.float32)
        self.observation_space = spaces.Box(-high, high, (4,), np.float32)
        self.action_space = spaces.Discrete(2)
        self._rng = np.random.default_rng(seed)
        self.state = np.zeros(4, np.float32)
        self.t = 0

    def reset(self, seed: int | None = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        self.t = 0
        return self.state.copy(), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = (_F32(v) for v in self.state)
        force = _FORCE_MAG if int(action) == 1 else -_FORCE_MAG
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + _POLEMASS_LENGTH * np.square(theta_dot) * sintheta) / _TOTAL_MASS
        thetaacc = (_GRAVITY * sintheta - costheta * temp) / (
            _LENGTH * (_FOUR_THIRDS - _MASSPOLE * np.square(costheta) / _TOTAL_MASS)
        )
        xacc = temp - _POLEMASS_LENGTH * thetaacc * costheta / _TOTAL_MASS
        # Euler integration (the gymnasium default)
        x = x + _TAU * x_dot
        x_dot = x_dot + _TAU * xacc
        theta = theta + _TAU * theta_dot
        theta_dot = theta_dot + _TAU * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot], dtype=np.float32)
        self.t += 1
        terminated = bool(abs(x) > _X_THRESHOLD or abs(theta) > _THETA_THRESHOLD)
        truncated = self.t >= self.max_episode_steps
        return self.state.copy(), 1.0, terminated, truncated, {}

    def close(self):
        pass
