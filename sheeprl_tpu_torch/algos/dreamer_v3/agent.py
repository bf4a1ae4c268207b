"""DreamerV3 player (the port of the player side of
sheeprl_tpu/algos/dreamer_v3/agent.py): the encoders, the RSSM's recurrent,
transition and representation models, the discrete-action actor, the
environment-interaction `PlayerDV3`, and the part of `build_models` that
builds them.

Randomness is explicit: a step takes injected Gumbel noise for the
posterior sample (the parity tests feed the reference's own draw) or a
`torch.Generator`; the reference threads `jax.random` keys instead.
Convolutions are NHWC, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ...nn.blocks import CNN, MLP
from ...nn.inits import init_xavier
from ...nn.layers import Linear
from ...nn.recurrent import LayerNormGRUCell
from ...ops.distributions import OneHotCategorical, gumbel_noise, unimix_logits
from ...ops.math import symlog

__all__ = [
    "Actor",
    "CNNEncoder",
    "Encoder",
    "MLPEncoder",
    "PlayerDV3",
    "PlayerState",
    "RSSM",
    "RecurrentModel",
    "build_models",
    "compute_stochastic_state",
    "exploration_actions",
]


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def compute_stochastic_state(
    logits: torch.Tensor, discrete: int, gumbel: torch.Tensor | None = None
) -> torch.Tensor:
    """Flat logits `[..., S*D]` -> one-hot state `[..., S, D]`: the mode when
    `gumbel` is None, else the Gumbel-max draw with that noise
    (`[..., S, D]`)."""
    logits = logits.reshape(*logits.shape[:-1], -1, discrete)
    dist = OneHotCategorical(logits)
    return dist.mode if gumbel is None else dist.rsample(gumbel)


class CNNEncoder(tnn.Module):
    """4-stage stride-2 conv encoder 64x64 -> 4x4, channels [1,2,4,8] x
    multiplier, LayerNorm(eps=1e-3) + SiLU. Image keys are concatenated on
    the channel axis."""

    def __init__(self, keys: Sequence[str], input_channels: int, image_size: tuple[int, int],
                 channels_multiplier: int, *, layer_norm: bool = True,
                 activation: str = "silu", generator: torch.Generator | None = None):
        super().__init__()
        channels = [channels_multiplier * m for m in (1, 2, 4, 8)]
        self.keys = tuple(keys)
        self.model = CNN(
            input_channels, channels, kernel_sizes=[4] * 4, strides=[2] * 4,
            act=activation, layer_norm=layer_norm, use_bias=not layer_norm, norm_eps=1e-3,
            generator=generator,
        )
        h, w = image_size
        for _ in range(4):  # SAME stride 2: ceil(size / 2) per stage
            h, w = -(-h // 2), -(-w // 2)
        self.output_dim = channels[-1] * h * w

    def forward(self, obs: dict) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)
        y = self.model(x)
        return y.reshape(*y.shape[:-3], -1)


class MLPEncoder(tnn.Module):
    """Vector encoder with symlog-squashed inputs."""

    def __init__(self, keys: Sequence[str], input_dim: int, *, mlp_layers: int = 4,
                 dense_units: int = 512, layer_norm: bool = True, activation: str = "silu",
                 symlog_inputs: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.keys = tuple(keys)
        self.symlog_inputs = symlog_inputs
        self.model = MLP(
            input_dim, [dense_units] * mlp_layers, act=activation, layer_norm=layer_norm,
            use_bias=not layer_norm, norm_eps=1e-3, generator=generator,
        )

    @property
    def output_dim(self) -> int:
        return self.model.output_dim

    def forward(self, obs: dict) -> torch.Tensor:
        x = torch.cat([symlog(obs[k]) if self.symlog_inputs else obs[k] for k in self.keys], dim=-1)
        return self.model(x)


class Encoder(tnn.Module):
    """Fused CNN+MLP encoder over the dict observation; either may be None."""

    def __init__(self, cnn_encoder: CNNEncoder | None, mlp_encoder: MLPEncoder | None):
        super().__init__()
        self.cnn_encoder = cnn_encoder
        self.mlp_encoder = mlp_encoder

    @property
    def output_dim(self) -> int:
        return sum(e.output_dim for e in (self.cnn_encoder, self.mlp_encoder) if e is not None)

    def forward(self, obs: dict) -> torch.Tensor:
        feats = [e(obs) for e in (self.cnn_encoder, self.mlp_encoder) if e is not None]
        return torch.cat(feats, dim=-1)


class RecurrentModel(tnn.Module):
    """Dense pre-projection + LayerNorm-GRU — the deterministic-state update."""

    def __init__(self, input_size: int, recurrent_state_size: int, dense_units: int, *,
                 layer_norm: bool = True, activation: str = "silu",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.mlp = MLP(
            input_size, [dense_units], act=activation, layer_norm=layer_norm,
            use_bias=not layer_norm, norm_eps=1e-3, generator=generator,
        )
        self.rnn = LayerNormGRUCell(
            dense_units, recurrent_state_size, layer_norm=True, use_bias=False, generator=generator
        )

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(self.mlp(x), recurrent_state)


class RSSM(tnn.Module):
    """The player's half of the Recurrent State-Space Model: discrete
    (S x D) stochastic state with 1% unimix."""

    def __init__(self, recurrent_model: RecurrentModel, representation_model: MLP,
                 transition_model: MLP, discrete: int = 32, unimix: float = 0.01):
        super().__init__()
        self.recurrent_model = recurrent_model
        self.representation_model = representation_model
        self.transition_model = transition_model
        self.discrete = discrete
        self.unimix = unimix

    def _uniform_mix(self, logits: torch.Tensor) -> torch.Tensor:
        shaped = logits.reshape(*logits.shape[:-1], -1, self.discrete)
        return unimix_logits(shaped, self.unimix).reshape(logits.shape)

    def _mix_sample(self, raw: torch.Tensor, gumbel: torch.Tensor | None, out_dtype: torch.dtype):
        """Raw head output -> (unimixed f32 logits, one-hot state in the
        compute dtype); the mode when `gumbel` is None."""
        logits = self._uniform_mix(raw.float())
        state = compute_stochastic_state(logits, self.discrete, gumbel)
        return logits, state.to(out_dtype)

    def _transition(self, recurrent_out: torch.Tensor, gumbel: torch.Tensor | None = None):
        """-> (prior_logits [..., S*D], prior [..., S, D])."""
        return self._mix_sample(self.transition_model(recurrent_out), gumbel, recurrent_out.dtype)

    def _representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor,
                        gumbel: torch.Tensor | None = None):
        """-> (posterior_logits [..., S*D], posterior [..., S, D])."""
        raw = self.representation_model(torch.cat([recurrent_state, embedded_obs], dim=-1))
        return self._mix_sample(raw, gumbel, recurrent_state.dtype)


class Actor(tnn.Module):
    """DreamerV3 policy head for discrete actions: MLP trunk + one head per
    discrete action space, unimix one-hot categoricals. Continuous control
    (the reference's best-of-100 truncated-normal draw) is not ported."""

    def __init__(self, latent_state_size: int, actions_dim: Sequence[int], is_continuous: bool, *,
                 dense_units: int = 512,
                 dense_act: str = "silu", mlp_layers: int = 2, distribution: str = "auto",
                 layer_norm: bool = True, unimix: float = 0.01,
                 generator: torch.Generator | None = None):
        super().__init__()
        distribution = distribution.lower()
        if distribution not in ("auto", "normal", "tanh_normal", "discrete", "trunc_normal"):
            raise ValueError(f"unknown actor distribution {distribution!r}")
        if is_continuous or distribution not in ("auto", "discrete"):
            raise NotImplementedError("continuous-action actors are not ported yet")
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = False
        self.unimix = unimix
        self.model = MLP(
            latent_state_size, [dense_units] * mlp_layers, act=dense_act, layer_norm=layer_norm,
            use_bias=not layer_norm, norm_eps=1e-3, generator=generator,
        )
        self.heads = tnn.ModuleList(Linear(dense_units, d, generator=generator) for d in self.actions_dim)

    def dists(self, state: torch.Tensor) -> tuple[OneHotCategorical, ...]:
        x = self.model(state)
        # distribution math runs in f32, whatever the trunk's dtype
        return tuple(
            OneHotCategorical(unimix_logits(head(x).float(), self.unimix)) for head in self.heads
        )

    def forward(self, state: torch.Tensor, is_training: bool = True,
                generator: torch.Generator | None = None):
        """-> (actions tuple, distributions tuple): straight-through draws from
        `generator` in training, the mode in evaluation."""
        dists = self.dists(state)
        if is_training:
            actions = tuple(d.rsample(generator=generator) for d in dists)
        else:
            actions = tuple(d.mode for d in dists)
        return actions, dists


@dataclass
class PlayerState:
    """The player's recurrent interaction state, one row per env."""

    actions: torch.Tensor  # [N, sum(actions_dim)]
    recurrent_state: torch.Tensor  # [N, R]
    stochastic_state: torch.Tensor  # [N, S*D]


def exploration_actions(
    actions: tuple[torch.Tensor, ...], is_continuous: bool, expl_amount: float,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Add exploration noise and concatenate the per-head actions: clipped
    Gaussian noise for continuous control, epsilon-uniform one-hot swaps per
    discrete head. With `expl_amount` 0 no draw changes an action, and none
    is made."""
    if is_continuous:
        cat = torch.cat(actions, dim=-1)
        if expl_amount <= 0.0:
            return cat
        noise = torch.randn(cat.shape, generator=generator, device=cat.device, dtype=cat.dtype)
        return torch.clamp(cat + expl_amount * noise, -1.0, 1.0)
    if expl_amount <= 0.0:
        return torch.cat(actions, dim=-1)
    out = []
    for act in actions:
        n = act.shape[-1]
        rand_idx = torch.randint(0, n, act.shape[:-1], generator=generator, device=act.device)
        rand_one_hot = F.one_hot(rand_idx, n).to(act.dtype)
        take = torch.rand(act.shape[:-1], generator=generator, device=act.device) < expl_amount
        out.append(torch.where(take[..., None], rand_one_hot, act))
    return torch.cat(out, dim=-1)


class PlayerDV3(tnn.Module):
    """Environment-interaction model: encoder + RSSM + actor. The recurrent
    state lives in an explicit PlayerState."""

    def __init__(self, encoder: Encoder, rssm: RSSM, actor: Actor, actions_dim: Sequence[int],
                 stochastic_size: int = 32, discrete_size: int = 32,
                 recurrent_state_size: int = 512, is_continuous: bool = False,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.encoder = encoder
        self.rssm = rssm
        self.actor = actor
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.stochastic_size = stochastic_size
        self.discrete_size = discrete_size
        self.recurrent_state_size = recurrent_state_size
        self.is_continuous = is_continuous
        self.compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return self.rssm.recurrent_model.rnn.proj.weight.device

    def init_states(self, n_envs: int) -> PlayerState:
        """Zero actions, zero recurrent state, transition-mode stochastic
        state."""
        dt = _dtype(self.compute_dtype)
        recurrent = torch.zeros((n_envs, self.recurrent_state_size), dtype=dt, device=self.device)
        stochastic = self.rssm._transition(recurrent)[1]
        return PlayerState(
            actions=torch.zeros((n_envs, sum(self.actions_dim)), dtype=dt, device=self.device),
            recurrent_state=recurrent,
            stochastic_state=stochastic.reshape(n_envs, -1),
        )

    def step(
        self,
        state: PlayerState,
        obs: dict,
        gumbel: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        expl_amount: float = 0.0,
        is_training: bool = True,
    ) -> tuple[PlayerState, torch.Tensor]:
        """One action step. The posterior is sampled with `gumbel`
        ([N, S, D]) when given, else with noise drawn from `generator`.
        Returns (new_state, actions [N, sum(actions_dim)])."""
        dt = _dtype(self.compute_dtype)
        obs = {k: v.to(dt) for k, v in obs.items()}
        embedded = self.encoder(obs)
        recurrent = self.rssm.recurrent_model(
            torch.cat([state.stochastic_state, state.actions], dim=-1), state.recurrent_state
        )
        if gumbel is None:
            shape = (recurrent.shape[0], self.stochastic_size, self.discrete_size)
            gumbel = gumbel_noise(shape, generator, recurrent.device)
        _, stochastic = self.rssm._representation(recurrent, embedded, gumbel)
        stochastic = stochastic.reshape(*stochastic.shape[:-2], -1)
        latent = torch.cat([stochastic, recurrent], dim=-1)
        actions, _ = self.actor(latent, is_training=is_training, generator=generator)
        cat = exploration_actions(actions, self.is_continuous, expl_amount, generator)
        new_state = PlayerState(actions=cat.to(dt), recurrent_state=recurrent, stochastic_state=stochastic)
        return new_state, cat


def build_models(
    generator: torch.Generator,
    actions_dim: Sequence[int],
    is_continuous: bool,
    args,
    obs_space: dict,
    cnn_keys: Sequence[str],
    mlp_keys: Sequence[str],
) -> tuple[Encoder, RSSM, Actor]:
    """Build the player's (encoder, rssm, actor) on the CPU with the Hafner
    initialization pass: Xavier-normal everywhere, Xavier-uniform on the
    distribution output layers (actor heads, transition and representation
    heads). The reference's `build_models` also builds the decoder, reward,
    continue and critic models, which only training needs."""
    if args.cnn_channels_multiplier <= 0:
        raise ValueError("cnn_channels_multiplier must be greater than zero")
    if args.dense_units <= 0:
        raise ValueError("dense_units must be greater than zero")
    g = generator
    stochastic_size = args.stochastic_size * args.discrete_size
    latent_state_size = stochastic_size + args.recurrent_state_size

    cnn_encoder = None
    if cnn_keys:
        cnn_encoder = CNNEncoder(
            cnn_keys, input_channels=sum(obs_space[k].shape[-1] for k in cnn_keys),
            image_size=obs_space[cnn_keys[0]].shape[:2],
            channels_multiplier=args.cnn_channels_multiplier, layer_norm=args.layer_norm,
            activation=args.cnn_act, generator=g,
        )
    mlp_encoder = None
    if mlp_keys:
        mlp_encoder = MLPEncoder(
            mlp_keys, input_dim=sum(obs_space[k].shape[0] for k in mlp_keys),
            mlp_layers=args.mlp_layers, dense_units=args.dense_units,
            layer_norm=args.layer_norm, activation=args.dense_act, generator=g,
        )
    encoder = Encoder(cnn_encoder, mlp_encoder)

    mlp_kwargs = dict(act=args.dense_act, layer_norm=args.layer_norm,
                      use_bias=not args.layer_norm, norm_eps=1e-3, generator=g)
    rssm = RSSM(
        RecurrentModel(
            int(sum(actions_dim)) + stochastic_size, args.recurrent_state_size, args.dense_units,
            layer_norm=args.layer_norm, activation=args.dense_act, generator=g,
        ),
        representation_model=MLP(
            args.recurrent_state_size + encoder.output_dim, [args.hidden_size], stochastic_size,
            **mlp_kwargs,
        ),
        transition_model=MLP(args.recurrent_state_size, [args.hidden_size], stochastic_size, **mlp_kwargs),
        discrete=args.discrete_size,
        unimix=args.unimix,
    )
    actor = Actor(
        latent_state_size, actions_dim, is_continuous, dense_units=args.dense_units,
        dense_act=args.dense_act,
        mlp_layers=args.mlp_layers, distribution=args.actor_distribution,
        layer_norm=args.layer_norm, unimix=args.unimix, generator=g,
    )
    for module in (encoder, rssm, actor):
        init_xavier(module, g, "normal")
    if args.hafner_initialization:
        for head in actor.heads:
            init_xavier(head, g, "uniform")
        init_xavier(rssm.transition_model.head, g, "uniform")
        init_xavier(rssm.representation_model.head, g, "uniform")
    return encoder, rssm, actor
