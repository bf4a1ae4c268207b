"""PPO agent (the port of sheeprl_tpu/algos/ppo/agent.py): a dict-observation
encoder (NatureCNN over the image keys, an MLP over the vector keys), an
actor backbone with one head per action space (discrete, multi-discrete or
a Gaussian for continuous actions) and a critic, and the helpers that turn
the agent's actions into env actions.

Parameter paths match the reference's field paths (`actor_heads.0.weight`,
`cnn_encoder.model.cnn.layers.0.kernel`), so `interop.ppo_agent_from_jax`
maps them one to one. `precision` picks the compute dtype of the encoders,
the backbone and the critic; logits, distributions and values are f32.
A sample takes its noise as a tensor (`PPOAgent.draw_noise`: Gumbel draws
for the one-hot heads, standard normal draws for the Gaussian), so the
draws can come from a CPU generator whatever the agent's device, as JAX's
draws are the same on every backend; `actions` can be given instead, as
the update and the parity tests do."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as tnn

from ...nn import MLP, Linear, NatureCNN
from ...ops.distributions import Independent, Normal, OneHotCategorical, gumbel_noise
from ...ops.precision import compute_dtype

__all__ = [
    "CNNEncoder", "MLPEncoder", "PPOAgent", "buffer_actions", "env_action_indices", "indices_to_env_actions",
    "indices_to_one_hot", "one_hot_to_env_actions",
]


class CNNEncoder(tnn.Module):
    """NatureCNN over the channel-concatenated image keys; uint8 NHWC input
    becomes [0, 1] in the compute dtype."""

    def __init__(self, in_channels: int, features_dim: int, screen_size: int, keys: Sequence[str],
                 channels_multiplier: int = 1, generator: torch.Generator | None = None):
        super().__init__()
        self.model = NatureCNN(in_channels, features_dim, screen_size=screen_size,
                               channels_multiplier=channels_multiplier, generator=generator)
        self.keys = tuple(keys)

    def forward(self, obs: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)
        return self.model(x.to(dtype) / 255.0)

    @property
    def output_dim(self) -> int:
        return self.model.output_dim


class MLPEncoder(tnn.Module):
    """MLP over the feature-concatenated vector keys."""

    def __init__(self, input_dim: int, features_dim: int, keys: Sequence[str], dense_units: int,
                 mlp_layers: int, dense_act: str, layer_norm: bool, generator: torch.Generator | None = None):
        super().__init__()
        self.model = MLP(input_dim, [dense_units] * mlp_layers, features_dim, act=dense_act,
                         layer_norm=layer_norm, generator=generator)
        self.keys = tuple(keys)

    def forward(self, obs: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.model(torch.cat([obs[k] for k in self.keys], dim=-1).to(dtype))

    @property
    def output_dim(self) -> int:
        return self.model.output_dim


class PPOAgent(tnn.Module):
    def __init__(self, actions_dim: Sequence[int], obs_space: dict, cnn_keys: Sequence[str],
                 mlp_keys: Sequence[str], *, cnn_features_dim: int = 512, mlp_features_dim: int = 64,
                 screen_size: int = 64, mlp_layers: int = 2, dense_units: int = 64, dense_act: str = "tanh",
                 layer_norm: bool = False, is_continuous: bool = False, actor_hidden_size: int | None = None,
                 critic_hidden_size: int | None = None, cnn_channels_multiplier: int = 1,
                 precision: str = "float32", generator: torch.Generator | None = None):
        super().__init__()
        actor_hidden_size = dense_units if actor_hidden_size is None else actor_hidden_size
        critic_hidden_size = dense_units if critic_hidden_size is None else critic_hidden_size
        if actor_hidden_size <= 0 or critic_hidden_size <= 0:
            raise ValueError("actor_hidden_size/critic_hidden_size must be greater than zero, given "
                             f"{actor_hidden_size}/{critic_hidden_size}")
        features_dim = 0
        self.cnn_encoder = None
        if cnn_keys:
            in_channels = sum(obs_space[k].shape[-1] for k in cnn_keys)
            self.cnn_encoder = CNNEncoder(in_channels, cnn_features_dim, screen_size, cnn_keys,
                                          cnn_channels_multiplier, generator)
            features_dim += cnn_features_dim
        self.mlp_encoder = None
        if mlp_keys:
            input_dim = sum(obs_space[k].shape[0] for k in mlp_keys)
            self.mlp_encoder = MLPEncoder(input_dim, mlp_features_dim, mlp_keys, dense_units, mlp_layers,
                                          dense_act, layer_norm, generator)
            features_dim += mlp_features_dim
        self.actor_backbone = MLP(features_dim, [actor_hidden_size] * mlp_layers, act=dense_act,
                                  layer_norm=layer_norm, generator=generator)
        if is_continuous:
            heads = [Linear(actor_hidden_size, int(sum(actions_dim)) * 2, generator=generator)]
        else:
            heads = [Linear(actor_hidden_size, int(d), generator=generator) for d in actions_dim]
        self.actor_heads = tnn.ModuleList(heads)
        self.critic = MLP(features_dim, [critic_hidden_size] * mlp_layers, 1, act=dense_act, generator=generator)
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = is_continuous
        self.compute_dtype = precision
        self._dtype = compute_dtype(precision)

    def features(self, obs: dict) -> torch.Tensor:
        feats = []
        if self.cnn_encoder is not None:
            feats.append(self.cnn_encoder(obs, dtype=self._dtype))
        if self.mlp_encoder is not None:
            feats.append(self.mlp_encoder(obs, dtype=self._dtype))
        return torch.cat(feats, dim=-1)

    def _pre_dist(self, feat: torch.Tensor) -> list[torch.Tensor]:
        out = self.actor_backbone(feat)
        # f32 island: the distributions' math runs full width
        return [head(out).float() for head in self.actor_heads]

    def draw_noise(self, generator: torch.Generator, *lead: int) -> torch.Tensor:
        """The noise of `lead` samples, `[*lead, sum(actions_dim)]` on the
        generator's device: Gumbel draws (discrete) or standard normal
        draws (continuous)."""
        shape = (*lead, sum(self.actions_dim))
        if self.is_continuous:
            return torch.randn(shape, generator=generator, device=generator.device)
        return gumbel_noise(shape, generator, generator.device)

    def forward(self, obs: dict, actions: torch.Tensor | None = None, noise: torch.Tensor | None = None):
        """-> (actions, logprob [..., 1], entropy [..., 1], values [..., 1]).
        Discrete and multi-discrete actions are one concatenated one-hot
        `[..., sum(actions_dim)]`, continuous ones raw values. Without
        `actions` they are sampled with `noise` (`draw_noise`): each head's
        one-hot by Gumbel-max, the Gaussian's as mean + std * noise."""
        feat = self.features(obs)
        pre_dist = self._pre_dist(feat)
        values = self.critic(feat).float()
        if actions is None and noise is None:
            raise ValueError("sampling actions needs their noise (PPOAgent.draw_noise)")
        if self.is_continuous:
            mean, log_std = torch.chunk(pre_dist[0], 2, dim=-1)
            normal = Independent(Normal(mean, torch.exp(log_std)), 1)
            if actions is None:
                actions = mean + torch.exp(log_std) * noise
            return actions, normal.log_prob(actions)[..., None], normal.entropy()[..., None], values
        given = None if actions is None else torch.split(actions, list(self.actions_dim), dim=-1)
        gumbels = None if noise is None else torch.split(noise, list(self.actions_dim), dim=-1)
        sampled, log_prob, entropy = [], 0.0, 0.0
        for i, logits in enumerate(pre_dist):
            dist = OneHotCategorical(logits)
            act = dist.sample(gumbel=gumbels[i]) if given is None else given[i]
            sampled.append(act)
            log_prob = log_prob + dist.log_prob(act)
            entropy = entropy + dist.entropy()
        return torch.cat(sampled, dim=-1), log_prob[..., None], entropy[..., None], values

    def get_value(self, obs: dict) -> torch.Tensor:
        return self.critic(self.features(obs)).float()

    def get_greedy_actions(self, obs: dict) -> torch.Tensor:
        pre_dist = self._pre_dist(self.features(obs))
        if self.is_continuous:
            return torch.chunk(pre_dist[0], 2, dim=-1)[0]
        return torch.cat([OneHotCategorical(lg).mode for lg in pre_dist], dim=-1)


def one_hot_to_env_actions(actions, actions_dim: Sequence[int], is_continuous: bool) -> np.ndarray:
    """The agent's actions (host array or tensor) as env.step takes them:
    the argmax index a head for (multi-)discrete, a scalar a row for one
    Discrete head; raw values for continuous."""
    actions = actions.detach().cpu().numpy() if isinstance(actions, torch.Tensor) else np.asarray(actions)
    if is_continuous:
        return actions
    heads = np.split(actions, np.cumsum(actions_dim)[:-1], axis=-1)
    stacked = np.stack([h.argmax(-1) for h in heads], axis=-1)
    return stacked[..., 0] if len(actions_dim) == 1 else stacked


def env_action_indices(actions: torch.Tensor, actions_dim: Sequence[int], is_continuous: bool) -> torch.Tensor:
    """Per-head argmax indices (int32, `[..., n_heads]`) computed where the
    actions are, so a step pulls a few ints to the host instead of the
    one-hot; continuous actions pass through."""
    if is_continuous:
        return actions
    heads = torch.split(actions, list(actions_dim), dim=-1)
    return torch.stack([h.argmax(-1) for h in heads], dim=-1).to(torch.int32)


def indices_to_env_actions(idx, actions_dim: Sequence[int], is_continuous: bool) -> np.ndarray:
    """The pulled indices shaped as env.step takes them (a scalar a row for
    one Discrete head, `[..., n_heads]` otherwise; continuous passes)."""
    idx = np.asarray(idx)
    if is_continuous or len(actions_dim) > 1:
        return idx
    return idx[..., 0]


def indices_to_one_hot(idx, actions_dim: Sequence[int]) -> np.ndarray:
    """Host one-hot rebuilt from per-head indices."""
    idx = np.asarray(idx)
    return np.concatenate([np.eye(d, dtype=np.float32)[idx[..., i]] for i, d in enumerate(actions_dim)], axis=-1)


def buffer_actions(env_idx, actions: torch.Tensor, actions_dim: Sequence[int], is_continuous: bool, host: bool):
    """A rollout row's actions: the policy step's tensor as it is for device
    storage; for host storage rebuilt from the pulled indices."""
    if not host:
        return actions
    if is_continuous:
        return np.asarray(env_idx, np.float32)
    return indices_to_one_hot(env_idx, actions_dim)
