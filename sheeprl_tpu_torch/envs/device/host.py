"""One device env stepped on the host (the port of
sheeprl_tpu/envs/jax/gym_compat.py:27, `JaxEnvGymWrapper`).

`HostTwin` runs a batched `DeviceEnv` at N = 1 on the CPU behind the
single-env API the host loops use (`reset(seed)` -> (obs, info),
`step(action)` -> (obs, reward, terminated, truncated, info), numpy
observations without the batch dim). It is how an env that exists only
on the device (`pixeltoy`) gets evaluation episodes and `--env_backend
host` runs: `utils/env.py:make_dict_env` dispatches `pixeltoy` here, as
the reference's `utils/env.py:234-239` does. The dynamics are the device
env's own functions. A reset draws from a CPU generator seeded by the
env's seed (or the seed `reset` is given)."""

from __future__ import annotations

import numpy as np
import torch

from .. import spaces
from .core import DeviceEnv

__all__ = ["HostTwin"]


class HostTwin:
    def __init__(self, env: DeviceEnv, seed: int = 0):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self._gen = torch.Generator().manual_seed(int(seed))
        self._state = None

    @staticmethod
    def _host_obs(obs: dict) -> dict:
        return {k: v[0].numpy() for k, v in obs.items()}

    def reset(self, seed: int | None = None, options=None):
        if seed is not None:
            self._gen = torch.Generator().manual_seed(int(seed))
        self._state = self.env.draw_resets(self._gen, (1,))
        return self._host_obs(self.env.observe(self._state)), {}

    def step(self, action):
        if isinstance(self.action_space, spaces.Discrete):
            a = torch.tensor([int(np.asarray(action).reshape(()))], dtype=torch.int32)
        else:
            a = torch.from_numpy(np.asarray(action, np.float32).reshape(1, -1))
        self._state, obs, reward, term, trunc = self.env.step(self._state, a)
        return self._host_obs(obs), float(reward[0]), bool(term[0]), bool(trunc[0]), {}

    def render(self):
        if self._state is not None and hasattr(self.env, "render"):
            return self.env.render(self._state)[0].numpy()
        return None

    def close(self):
        pass
