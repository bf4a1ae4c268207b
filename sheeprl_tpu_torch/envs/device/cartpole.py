"""Batched CartPole-v1 on the device (the port of sheeprl_tpu/envs/jax/cartpole.py).

The reference's JAX CartPole for N envs at once: gymnasium's
Euler-integrated cart-pole ODE, its constants and termination thresholds,
the 500-step `TimeLimit` truncation folded into a step counter, float32
arithmetic in the reference's order of operations, reward 1.0 a step. The
constants are the host twin's (`envs/cartpole.py`), each rounded once to
float32 as the reference's Python floats meet its float32 arrays. A reset
draws the state uniform in +-0.05."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import spaces
from ..cartpole import (
    _FORCE_MAG, _FOUR_THIRDS, _GRAVITY, _LENGTH, _MASSPOLE, _POLEMASS_LENGTH, _TAU, _THETA_THRESHOLD, _TOTAL_MASS,
    _X_THRESHOLD,
)
from .core import DeviceEnv

__all__ = ["CartPoleState", "DeviceCartPole"]


@dataclass
class CartPoleState:
    state: torch.Tensor  # [N, 4] f32: x, x_dot, theta, theta_dot
    t: torch.Tensor  # [N] i32 steps since reset (the TimeLimit counter)


class DeviceCartPole(DeviceEnv):
    State = CartPoleState

    def __init__(self, max_episode_steps: int = 500):
        self.max_episode_steps = int(max_episode_steps)
        high = np.array([_X_THRESHOLD * 2, np.inf, _THETA_THRESHOLD * 2, np.inf], dtype=np.float32)
        self.observation_space = spaces.Dict({"state": spaces.Box(-high, high, (4,), np.float32)})
        self.action_space = spaces.Discrete(2)

    def draw_resets(self, generator: torch.Generator, lead: tuple) -> CartPoleState:
        u = torch.rand((*lead, 4), generator=generator, device=generator.device)
        return CartPoleState(state=u * 0.1 - 0.05, t=torch.zeros(lead, dtype=torch.int32, device=u.device))

    def observe(self, state: CartPoleState) -> dict:
        return {"state": state.state}

    def step(self, state: CartPoleState, actions: torch.Tensor):
        x, x_dot, theta, theta_dot = state.state.unbind(-1)
        force = torch.where(actions == 1, float(_FORCE_MAG), -float(_FORCE_MAG))
        costheta = torch.cos(theta)
        sintheta = torch.sin(theta)
        temp = (force + float(_POLEMASS_LENGTH) * torch.square(theta_dot) * sintheta) / float(_TOTAL_MASS)
        thetaacc = (float(_GRAVITY) * sintheta - costheta * temp) / (
            float(_LENGTH) * (float(_FOUR_THIRDS) - float(_MASSPOLE) * torch.square(costheta) / float(_TOTAL_MASS))
        )
        xacc = temp - float(_POLEMASS_LENGTH) * thetaacc * costheta / float(_TOTAL_MASS)
        # Euler integration (the gymnasium default)
        x = x + float(_TAU) * x_dot
        x_dot = x_dot + float(_TAU) * xacc
        theta = theta + float(_TAU) * theta_dot
        theta_dot = theta_dot + float(_TAU) * thetaacc
        new = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        t = state.t + 1
        terminated = (x.abs() > float(_X_THRESHOLD)) | (theta.abs() > float(_THETA_THRESHOLD))
        truncated = t >= self.max_episode_steps
        reward = torch.ones_like(x)
        nxt = CartPoleState(state=new, t=t)
        return nxt, self.observe(nxt), reward, terminated, truncated
