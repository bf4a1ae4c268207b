"""SAC actor (the port of sheeprl_tpu/algos/sac/agent.py:31-118,
`SACActor`): the tanh-squashed Gaussian policy that serving runs. The
critics, `CriticEnsemble` and `SACAgent` come with SAC training.

Parameter paths are the reference's field paths (`model.layers.0`,
`fc_mean`, `fc_logstd`, `action_scale`, `action_bias`), so `interop.py`
carries its weights across and a `quant_scales.npz` keys the same Linears.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as tnn

from ...nn.blocks import MLP
from ...nn.layers import Linear
from ...ops.precision import compute_dtype

LOG_STD_MIN = -5.0
LOG_STD_MAX = 2.0

__all__ = ["SACActor"]


class SACActor(tnn.Module):
    """Squashed-Gaussian policy: a 2-layer ReLU trunk without a head,
    mean / log_std heads, tanh squash rescaled to the env's action bounds
    (`action_scale`, `action_bias`: buffers, never trained), log-prob with
    the tanh change-of-variable correction. The trunk runs in
    `compute_dtype`; the heads' outputs are upcast to f32."""

    def __init__(self, observation_dim: int, action_dim: int, *, hidden_size: int = 256,
                 action_low=-1.0, action_high=1.0, precision: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.model = MLP(observation_dim, [hidden_size, hidden_size], act="relu", generator=generator)
        self.fc_mean = Linear(hidden_size, action_dim, generator=generator)
        self.fc_logstd = Linear(hidden_size, action_dim, generator=generator)
        self.compute_dtype = precision
        low = np.asarray(action_low, np.float32)
        high = np.asarray(action_high, np.float32)
        scale = np.broadcast_to((high - low) / np.float32(2.0), (action_dim,))
        bias = np.broadcast_to((high + low) / np.float32(2.0), (action_dim,))
        self.register_buffer("action_scale", torch.tensor(scale, dtype=torch.float32))
        self.register_buffer("action_bias", torch.tensor(bias, dtype=torch.float32))

    def dist_params(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.model(obs.to(compute_dtype(self.compute_dtype)))
        # f32 island: the distribution's parameters and everything after
        mean = self.fc_mean(x).float()
        log_std = self.fc_logstd(x).float().clamp(LOG_STD_MIN, LOG_STD_MAX)
        return mean, log_std.exp()

    def forward(self, obs: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """Reparameterized tanh-squashed sample and its log-prob
        [..., 1]. The standard-normal `noise` is drawn from `generator` (on
        the actor's device) unless it is given."""
        mean, std = self.dist_params(obs)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
        x_t = mean + std * noise
        y_t = torch.tanh(x_t)
        action = y_t * self.action_scale + self.action_bias
        # Normal log-prob minus the tanh-squash jacobian term
        log_prob = -0.5 * ((x_t - mean) / std).square() - std.log() - 0.5 * math.log(2.0 * math.pi)
        log_prob = log_prob - torch.log(self.action_scale * (1.0 - y_t.square()) + 1e-6)
        return action, log_prob.sum(dim=-1, keepdim=True)

    def get_greedy_actions(self, obs: torch.Tensor) -> torch.Tensor:
        mean, _ = self.dist_params(obs)
        return torch.tanh(mean) * self.action_scale + self.action_bias
