"""Batched Pendulum-v1 on the device (the port of sheeprl_tpu/envs/jax/pendulum.py).

The reference's JAX Pendulum for N envs at once: gymnasium's
torque-limited swing-up ODE, its cost and reset distribution in float32,
the 200-step `TimeLimit` truncation folded into a step counter; the
torque is clipped to +-2 and the env never terminates. The constants are
the host twin's (`envs/pendulum.py`), rounded once to float32. A reset
draws (theta, theta_dot) uniform in [-pi, pi] x [-1, 1]."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import spaces
from ..pendulum import _DT, _GRAVITY_TERM, _MAX_SPEED, _MAX_TORQUE, _PI, _RESET_HIGH, _TORQUE_TERM, _TWO_PI
from .core import DeviceEnv

__all__ = ["DevicePendulum", "PendulumState"]


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + float(_PI), float(_TWO_PI)) - float(_PI)


@dataclass
class PendulumState:
    state: torch.Tensor  # [N, 2] f32: theta, theta_dot
    t: torch.Tensor  # [N] i32 steps since reset (the TimeLimit counter)


class DevicePendulum(DeviceEnv):
    State = PendulumState

    def __init__(self, max_episode_steps: int = 200):
        self.max_episode_steps = int(max_episode_steps)
        high = np.array([1.0, 1.0, _MAX_SPEED], dtype=np.float32)
        self.observation_space = spaces.Dict({"state": spaces.Box(-high, high, (3,), np.float32)})
        self.action_space = spaces.Box(-_MAX_TORQUE, _MAX_TORQUE, (1,), np.float32)

    def draw_resets(self, generator: torch.Generator, lead: tuple) -> PendulumState:
        u = torch.rand((*lead, 2), generator=generator, device=generator.device) * 2.0 - 1.0
        state = torch.stack([u[..., 0] * float(_RESET_HIGH[0]), u[..., 1] * float(_RESET_HIGH[1])], dim=-1)
        return PendulumState(state=state, t=torch.zeros(lead, dtype=torch.int32, device=u.device))

    def observe(self, state: PendulumState) -> dict:
        th, thdot = state.state.unbind(-1)
        return {"state": torch.stack([torch.cos(th), torch.sin(th), thdot], dim=-1)}

    def step(self, state: PendulumState, actions: torch.Tensor):
        th, thdot = state.state.unbind(-1)
        u = torch.clamp(actions.reshape(th.shape), -float(_MAX_TORQUE), float(_MAX_TORQUE))
        costs = _angle_normalize(th) ** 2 + 0.1 * thdot ** 2 + 0.001 * (u ** 2)
        newthdot = thdot + (float(_GRAVITY_TERM) * torch.sin(th) + float(_TORQUE_TERM) * u) * float(_DT)
        newthdot = torch.clamp(newthdot, -float(_MAX_SPEED), float(_MAX_SPEED))
        newth = th + newthdot * float(_DT)
        t = state.t + 1
        nxt = PendulumState(state=torch.stack([newth, newthdot], dim=-1), t=t)
        return nxt, self.observe(nxt), -costs, torch.zeros_like(t, dtype=torch.bool), t >= self.max_episode_steps
