"""Batched PixelToy on the device (the port of sheeprl_tpu/envs/jax/pixeltoy.py).

A grid-world chase rendered on the device as uint8 NHWC frames: the agent
(a red block) must reach the goal (a green block) on a `grid x grid` board
drawn into `size x size x 3` images under `"rgb"`, the layout the host
pixel pipeline emits, so the CNN encoders run unchanged. Five discrete
actions (noop, up, down, left, right), reward +1 at the goal and
`-step_penalty` otherwise, termination at the goal, truncation at
`max_episode_steps`. The render is broadcasting arithmetic over the
batch. A reset draws the agent's and the goal's cells; where the goal
lands on the agent it moves one cell along each axis (mod grid), the
reference's one deterministic re-roll. There is no host env: the host
twin (`host.py`) steps this one at N = 1."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import spaces
from .core import DeviceEnv

__all__ = ["DevicePixelToy", "PixelToyState"]

N_MOVES = 5  # noop, up, down, left, right


@dataclass
class PixelToyState:
    agent: torch.Tensor  # [N, 2] i32 (row, col) in grid cells
    goal: torch.Tensor  # [N, 2] i32 (row, col) in grid cells
    t: torch.Tensor  # [N] i32 steps since reset


class DevicePixelToy(DeviceEnv):
    State = PixelToyState

    def __init__(self, size: int = 64, grid: int = 16, max_episode_steps: int = 128, step_penalty: float = 0.01):
        self.size, self.grid = int(size), int(grid)
        self.max_episode_steps = int(max_episode_steps)
        self.step_penalty = float(step_penalty)
        self.observation_space = spaces.Dict({"rgb": spaces.Box(0, 255, (self.size, self.size, 3), np.uint8)})
        self.action_space = spaces.Discrete(N_MOVES)

    def draw_resets(self, generator: torch.Generator, lead: tuple) -> PixelToyState:
        cells = torch.randint(0, self.grid, (2, *lead, 2), generator=generator, device=generator.device,
                              dtype=torch.int32)
        agent, goal = cells[0], cells[1]
        collide = (goal == agent).all(-1, keepdim=True)
        goal = torch.where(collide, (goal + 1) % self.grid, goal)
        return PixelToyState(agent=agent, goal=goal, t=torch.zeros(lead, dtype=torch.int32, device=agent.device))

    def render(self, state: PixelToyState) -> torch.Tensor:
        """[N, size, size, 3] uint8: the agent's cell 255 in red, the goal's
        in green."""
        px = torch.arange(self.size, device=state.agent.device, dtype=torch.int32) // (self.size // self.grid)

        def block(cell: torch.Tensor) -> torch.Tensor:
            rows = px == cell[..., 0, None]  # [N, size]
            cols = px == cell[..., 1, None]
            return rows[..., :, None] & cols[..., None, :]

        agent, goal = block(state.agent), block(state.goal)
        return torch.stack([agent, goal, torch.zeros_like(agent)], dim=-1).to(torch.uint8) * 255

    def observe(self, state: PixelToyState) -> dict:
        return {"rgb": self.render(state)}

    def step(self, state: PixelToyState, actions: torch.Tensor):
        a = actions.to(torch.int32)
        move = torch.stack([(a == 2).to(torch.int32) - (a == 1).to(torch.int32),
                            (a == 4).to(torch.int32) - (a == 3).to(torch.int32)], dim=-1)
        agent = torch.clamp(state.agent + move, 0, self.grid - 1)
        reached = (agent == state.goal).all(-1)
        t = state.t + 1
        nxt = PixelToyState(agent=agent, goal=state.goal, t=t)
        reward = torch.where(reached, 1.0, -self.step_penalty).to(torch.float32)
        return nxt, self.observe(nxt), reward, reached, t >= self.max_episode_steps
