"""The SAC agent (the port of sheeprl_tpu/algos/sac/agent.py): the
tanh-squashed Gaussian actor that serving runs (`SACActor`), the critic
ensemble (`SACCritic`, `CriticEnsemble`) and `SACAgent`, which adds the
target critics, the temperature `log_alpha` and the soft target update.

Parameter paths are the reference's field paths (`actor.model.layers.0`,
`fc_mean`, `fc_logstd`, `action_scale`, `action_bias`,
`critics.members.model.layers.0`, `target_critics...`, `log_alpha`), so
`interop.py` carries its weights across and a `quant_scales.npz` keys the
same Linears. The ensemble's members are stacked, as the reference vmaps
them: every critic parameter has a leading `[n]` axis, its weights are
`[n, in, out]` (the reference's layout), and each layer of all `n`
critics is one batched product (`nn/layers.py:StackedLinear`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as tnn

from ...nn.blocks import MLP, StackedMLP
from ...nn.layers import Linear
from ...ops.precision import compute_dtype

LOG_STD_MIN = -5.0
LOG_STD_MAX = 2.0

__all__ = ["CriticEnsemble", "SACActor", "SACAgent", "SACCritic"]


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


class SACCritic(tnn.Module):
    """Q(s, a) of `n` critics at once: an MLP over the concatenated
    observation and action (the reference's `SACCritic`, agent.py:121),
    its members stacked (`StackedMLP`, ReLU, `[hidden, hidden]`, one
    output). `layer_norm` and `dropout` make it DroQ's critic. The trunk
    runs in `compute_dtype`; the Q-values are upcast to f32."""

    def __init__(self, n: int, input_dim: int, *, hidden_size: int = 256, num_outputs: int = 1,
                 layer_norm: bool = False, dropout: float = 0.0, precision: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.model = StackedMLP(n, input_dim, [hidden_size, hidden_size], num_outputs, act="relu",
                                layer_norm=layer_norm, dropout_rate=dropout, generator=generator)
        self.compute_dtype = precision

    def forward(self, obs: torch.Tensor, action: torch.Tensor, uniforms=None) -> torch.Tensor:
        """[B, *] -> [n, B, num_outputs]; `uniforms` are the dropout draws
        (`[n, B, hidden]` a hidden layer), none for no dropout."""
        dt = compute_dtype(self.compute_dtype)
        x = torch.cat([obs.to(dt), action.to(dt)], dim=-1)
        return self.model(x, uniforms).float()


class CriticEnsemble(tnn.Module):
    """`n` critics as one module with stacked parameters (the reference's
    `CriticEnsemble`, agent.py:147, whose `members` is one vmapped
    `SACCritic`) -> `[B, n]` Q-values."""

    def __init__(self, n: int, input_dim: int, *, hidden_size: int = 256, precision: str = "float32",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n = n
        self.members = SACCritic(n, input_dim, hidden_size=hidden_size, precision=precision, generator=generator)

    def forward(self, obs: torch.Tensor, action: torch.Tensor, uniforms=None) -> torch.Tensor:
        return self.members(obs, action, uniforms)[..., 0].movedim(0, -1)


class SACAgent(tnn.Module):
    """Actor, critic ensemble, target critics (a distinct copy, never
    trained), the temperature `log_alpha` (`[1]`) and the target entropy
    `-act_dim` (the reference's `SACAgent`, agent.py:172)."""

    def __init__(self, observation_dim: int, action_dim: int, *, num_critics: int = 2,
                 actor_hidden_size: int = 256, critic_hidden_size: int = 256, action_low=-1.0,
                 action_high=1.0, alpha: float = 1.0, tau: float = 0.005, target_entropy: float | None = None,
                 precision: str = "float32", generator: torch.Generator | None = None):
        super().__init__()
        self.actor = SACActor(observation_dim, action_dim, hidden_size=actor_hidden_size, action_low=action_low,
                              action_high=action_high, precision=precision, generator=generator)
        ensemble = (num_critics, observation_dim + action_dim, critic_hidden_size, precision, generator)
        self.critics = self.critic_ensemble(*ensemble)
        self.target_critics = self.critic_ensemble(*ensemble)
        self.target_critics.load_state_dict(self.critics.state_dict())
        self.target_critics.requires_grad_(False)
        self.log_alpha = tnn.Parameter(torch.log(torch.tensor([alpha], dtype=torch.float32)))
        self.target_entropy = float(-action_dim) if target_entropy is None else float(target_entropy)
        self.tau = float(tau)

    def critic_ensemble(self, n: int, input_dim: int, hidden_size: int, precision: str,
                        generator: torch.Generator | None) -> CriticEnsemble:
        return CriticEnsemble(n, input_dim, hidden_size=hidden_size, precision=precision, generator=generator)

    @property
    def alpha(self) -> torch.Tensor:
        return self.log_alpha.exp()

    @torch.no_grad()
    def get_next_target_q_values(self, next_obs: torch.Tensor, rewards: torch.Tensor, dones: torch.Tensor,
                                 gamma: float, noise: torch.Tensor, uniforms=None) -> torch.Tensor:
        """TD target r + (1 - d) * gamma * (min_i Q_target_i(s', a') - alpha
        log pi(a'|s')), a' drawn with the standard-normal `noise`
        (reference agent.py:250); `uniforms` are the target critics'
        dropout draws (DroQ's, none for SAC)."""
        next_actions, next_log_pi = self.actor(next_obs, noise)
        q_next = self.target_critics(next_obs, next_actions, uniforms)
        min_q_next = q_next.min(dim=-1, keepdim=True).values - self.alpha * next_log_pi
        return rewards + (1.0 - dones) * gamma * min_q_next

    @torch.no_grad()
    def qfs_target_ema(self, do_update: torch.Tensor | bool = True) -> None:
        """The soft target update `where(do, tau p + (1 - tau) t, t)` in
        place (reference agent.py:266); `do_update` may be a device bool,
        so one CUDA graph serves every `target_network_frequency`."""
        params = list(self.critics.parameters())
        targets = list(self.target_critics.parameters())
        new = torch._foreach_mul(params, self.tau)
        torch._foreach_add_(new, torch._foreach_mul(targets, 1.0 - self.tau))
        if isinstance(do_update, bool):
            if do_update:
                torch._foreach_copy_(targets, new)
            return
        for t, v in zip(targets, new):
            t.copy_(torch.where(do_update, v, t))
