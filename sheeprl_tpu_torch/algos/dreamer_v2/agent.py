"""DreamerV2 agent (the port of sheeprl_tpu/algos/dreamer_v2/agent.py): the
V2 encoders and decoders, the recurrent model, `RSSMV2`, `PlayerDV2` and
`build_models`. The world-model container, the actor, the sequence loop
and the player's steps are DreamerV3's (`algos/dreamer_v3/agent.py`),
subclassed as the reference subclasses its own. What makes it V2:

  - VALID convolutions with ELU and biases: the encoder takes 64x64 to
    2x2 with k4/s2 stages, the decoder grows a 1x1 latent map to 64x64
    with kernels 5, 5, 6, 6 at stride 2 (1 -> 5 -> 13 -> 30 -> 64);
  - no unimix, and on `is_first` the action, posterior and recurrent state
    are zeroed, not re-seeded from the transition prior;
  - the LayerNorm-GRU keeps its projection's bias;
  - the player's stochastic state starts at zeros.

Neither the conv stages nor the GRU meet a kernel's guard (the fused stages
take k4/s2 SAME convolutions with LayerNorm, SiLU and no bias; the GRU
kernel a bias-free projection; the fused RSSM step both), so this path runs
plain PyTorch, as the reference's runs plain XLA.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.nn as tnn

from ...nn.blocks import CNN, MLP, DeCNN
from ...nn.inits import init_xavier
from ...nn.layers import Linear
from ...nn.recurrent import LayerNormGRUCell
from ..dreamer_v3.agent import Actor, Decoder, Encoder, PlayerDV3, PlayerState, RSSM, WorldModel, _dtype

__all__ = [
    "CNNDecoder", "CNNEncoder", "MLPDecoder", "MLPEncoder", "PlayerDV2", "RSSMV2", "RecurrentModel", "build_models",
]


class CNNEncoder(tnn.Module):
    """Four k4/s2 VALID convolutions, 64x64 -> 2x2, channels [1, 2, 4, 8] x
    multiplier, with biases; image keys concatenated on the channel axis."""

    def __init__(self, keys: Sequence[str], input_channels: int, image_size: tuple[int, int],
                 channels_multiplier: int, *, layer_norm: bool = False, activation: str = "elu",
                 generator: torch.Generator | None = None):
        super().__init__()
        channels = [channels_multiplier * m for m in (1, 2, 4, 8)]
        self.keys = tuple(keys)
        self.model = CNN(input_channels, channels, kernel_sizes=[4] * 4, strides=[2] * 4,
                         paddings=["VALID"] * 4, act=activation, layer_norm=layer_norm, generator=generator)
        h, w = image_size
        for _ in range(4):  # VALID k4 s2
            h, w = (h - 4) // 2 + 1, (w - 4) // 2 + 1
        self.output_dim = channels[-1] * h * w

    def forward(self, obs: dict) -> torch.Tensor:
        y = self.model(torch.cat([obs[k] for k in self.keys], dim=-1))
        return y.reshape(*y.shape[:-3], -1)


class MLPEncoder(tnn.Module):
    """Vector encoder, no symlog; a non-float key becomes f32."""

    def __init__(self, keys: Sequence[str], input_dim: int, *, mlp_layers: int = 4, dense_units: int = 512,
                 layer_norm: bool = False, activation: str = "elu", generator: torch.Generator | None = None):
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(input_dim, [dense_units] * mlp_layers, act=activation, layer_norm=layer_norm,
                         generator=generator)

    @property
    def output_dim(self) -> int:
        return self.model.output_dim

    def forward(self, obs: dict) -> torch.Tensor:
        x = torch.cat([obs[k] for k in self.keys], dim=-1)
        return self.model(x if x.is_floating_point() else x.float())


class CNNDecoder(tnn.Module):
    """latent -> Linear -> [1, 1, C] -> four VALID transposed convolutions
    (kernels 5, 5, 6, 6, stride 2; the last without norm or activation) ->
    the 64x64 image dict."""

    def __init__(self, keys: Sequence[str], output_channels: Sequence[int], channels_multiplier: int,
                 latent_state_size: int, cnn_encoder_output_dim: int, *, layer_norm: bool = False,
                 activation: str = "elu", generator: torch.Generator | None = None):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(output_channels)
        self.proj = Linear(latent_state_size, cnn_encoder_output_dim, generator=generator)
        self.model = DeCNN(
            cnn_encoder_output_dim, [channels_multiplier * m for m in (4, 2, 1)] + [sum(output_channels)],
            kernel_sizes=[5, 5, 6, 6], strides=[2] * 4, paddings=["VALID"] * 4, act=activation,
            layer_norm=layer_norm, generator=generator,
        )

    def forward(self, latent: torch.Tensor) -> dict:
        x = self.proj(latent)
        img = self.model(x.reshape(*x.shape[:-1], 1, 1, x.shape[-1]))
        return dict(zip(self.keys, torch.split(img, list(self.output_channels), dim=-1)))


class MLPDecoder(tnn.Module):
    """Per-key vector reconstruction heads over a shared MLP trunk."""

    def __init__(self, keys: Sequence[str], output_dims: Sequence[int], latent_state_size: int, *,
                 mlp_layers: int = 4, dense_units: int = 512, layer_norm: bool = False, activation: str = "elu",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(latent_state_size, [dense_units] * mlp_layers, act=activation, layer_norm=layer_norm,
                         generator=generator)
        self.heads = tnn.ModuleDict(
            {k: Linear(dense_units, dim, generator=generator) for k, dim in zip(keys, output_dims)}
        )

    def forward(self, latent: torch.Tensor) -> dict:
        x = self.model(latent)
        return {k: self.heads[k](x) for k in self.keys}


class RecurrentModel(tnn.Module):
    """Dense pre-projection, then a LayerNorm-GRU that keeps its bias (so the
    GRU kernel's guard refuses it and the cell runs plain)."""

    def __init__(self, input_size: int, recurrent_state_size: int, dense_units: int, *, layer_norm: bool = False,
                 activation: str = "elu", generator: torch.Generator | None = None):
        super().__init__()
        self.mlp = MLP(input_size, [dense_units], act=activation, layer_norm=layer_norm, generator=generator)
        self.rnn = LayerNormGRUCell(dense_units, recurrent_state_size, layer_norm=True, use_bias=True,
                                    generator=generator)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(self.mlp(x), recurrent_state)


class RSSMV2(RSSM):
    """DreamerV3's RSSM built with unimix 0, whose `is_first` only zeroes
    the previous action, posterior and recurrent state: no re-seed from the
    transition prior."""

    def _reset(self, posterior: torch.Tensor, recurrent_state: torch.Tensor, action: torch.Tensor,
               is_first: torch.Tensor):
        dt = recurrent_state.dtype
        keep = 1.0 - is_first.to(dt)
        posterior_flat = keep * posterior.to(dt).reshape(*posterior.shape[:-2], -1)
        return torch.cat([posterior_flat, keep * action.to(dt)], dim=-1), keep * recurrent_state


class PlayerDV2(PlayerDV3):
    """DreamerV3's player with a zero initial stochastic state."""

    def init_states(self, n_envs: int) -> PlayerState:
        dt = _dtype(self.compute_dtype)
        zeros = lambda width: torch.zeros((n_envs, width), dtype=dt, device=self.device)  # noqa: E731
        return PlayerState(actions=zeros(sum(self.actions_dim)), recurrent_state=zeros(self.recurrent_state_size),
                           stochastic_state=zeros(self.stochastic_size * self.discrete_size))


def build_models(
    generator: torch.Generator,
    actions_dim: Sequence[int],
    is_continuous: bool,
    args,
    obs_space: dict,
    cnn_keys: Sequence[str],
    mlp_keys: Sequence[str],
) -> tuple[WorldModel, Actor, MLP, MLP]:
    """Build (world_model, actor, critic, target_critic) on the CPU with
    Xavier-normal weights and zero biases everywhere (V2 has no Hafner
    init); the target critic is a deep copy of the critic."""
    if args.cnn_channels_multiplier <= 0:
        raise ValueError("cnn_channels_multiplier must be greater than zero")
    if args.dense_units <= 0:
        raise ValueError("dense_units must be greater than zero")
    g = generator
    stochastic_size = args.stochastic_size * args.discrete_size
    latent_state_size = stochastic_size + args.recurrent_state_size
    cnn_encoder = mlp_encoder = cnn_decoder = mlp_decoder = None
    if cnn_keys:
        cnn_encoder = CNNEncoder(
            cnn_keys, input_channels=sum(obs_space[k].shape[-1] for k in cnn_keys),
            image_size=obs_space[cnn_keys[0]].shape[:2], channels_multiplier=args.cnn_channels_multiplier,
            layer_norm=args.layer_norm, activation=args.cnn_act, generator=g,
        )
    if mlp_keys:
        mlp_encoder = MLPEncoder(
            mlp_keys, input_dim=sum(obs_space[k].shape[0] for k in mlp_keys), mlp_layers=args.mlp_layers,
            dense_units=args.dense_units, layer_norm=args.layer_norm, activation=args.dense_act, generator=g,
        )
    encoder = Encoder(cnn_encoder, mlp_encoder)
    mlp_kwargs = dict(act=args.dense_act, layer_norm=args.layer_norm, generator=g)
    rssm = RSSMV2(
        RecurrentModel(int(sum(actions_dim)) + stochastic_size, args.recurrent_state_size, args.dense_units,
                       layer_norm=args.layer_norm, activation=args.dense_act, generator=g),
        representation_model=MLP(args.recurrent_state_size + encoder.output_dim, [args.hidden_size],
                                 stochastic_size, **mlp_kwargs),
        transition_model=MLP(args.recurrent_state_size, [args.hidden_size], stochastic_size, **mlp_kwargs),
        discrete=args.discrete_size,
        unimix=0.0,
    )
    if cnn_keys:
        cnn_decoder = CNNDecoder(
            cnn_keys, output_channels=[obs_space[k].shape[-1] for k in cnn_keys],
            channels_multiplier=args.cnn_channels_multiplier, latent_state_size=latent_state_size,
            cnn_encoder_output_dim=cnn_encoder.output_dim, layer_norm=args.layer_norm, activation=args.cnn_act,
            generator=g,
        )
    if mlp_keys:
        mlp_decoder = MLPDecoder(
            mlp_keys, output_dims=[obs_space[k].shape[0] for k in mlp_keys], latent_state_size=latent_state_size,
            mlp_layers=args.mlp_layers, dense_units=args.dense_units, layer_norm=args.layer_norm,
            activation=args.dense_act, generator=g,
        )
    hidden = [args.dense_units] * args.mlp_layers
    world_model = WorldModel(
        encoder, rssm, Decoder(cnn_decoder, mlp_decoder),
        reward_model=MLP(latent_state_size, hidden, 1, **mlp_kwargs),
        continue_model=MLP(latent_state_size, hidden, 1, **mlp_kwargs),
    )
    actor = Actor(
        latent_state_size, actions_dim, is_continuous, init_std=args.actor_init_std, min_std=args.actor_min_std,
        dense_units=args.dense_units, dense_act=args.dense_act, mlp_layers=args.mlp_layers,
        distribution=args.actor_distribution, layer_norm=args.layer_norm, unimix=0.0, generator=g,
    )
    critic = MLP(latent_state_size, hidden, 1, **mlp_kwargs)
    for module in (world_model, actor, critic):
        init_xavier(module, g, "normal")
    return world_model, actor, critic, copy.deepcopy(critic)
