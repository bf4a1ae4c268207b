"""DreamerV1 agent (the port of sheeprl_tpu/algos/dreamer_v1/agent.py):
`compute_stochastic_state`, the recurrent model, the Gaussian `RSSMV1`,
`PlayerDV1` and `build_models`. The encoders and decoders are DreamerV2's
(`algos/dreamer_v2/agent.py`), the world-model container, the actor and
the player's steps DreamerV3's, as in the reference. What makes it V1:

  - the stochastic state is a diagonal Gaussian, `Normal(mean,
    softplus(std) + min_std)`, sampled by reparameterization from given
    standard normals (the reference draws `jax.random.normal`; the parity
    tests feed its draw); its mean and std are computed in f32;
  - no `is_first` anywhere: the recurrence just runs;
  - the recurrent model is a Linear and ELU into the textbook `GRUCell`
    (no LayerNorm);
  - the actor is tanh-normal for continuous actions (discrete heads
    otherwise), without unimix; every Linear starts Kaiming-normal.

No kernel takes any of it: the GRU kernels take the LayerNorm-GRU, the
conv kernels SiLU with LayerNorm, and the two-hot kernel a two-hot head.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ...nn.blocks import MLP
from ...nn.inits import init_kaiming_normal
from ...nn.layers import Linear
from ...nn.recurrent import GRUCell
from ...ops.distributions import standard_normal
from ...ops.scan import checkpoint_body
from ..dreamer_v2.agent import CNNDecoder, CNNEncoder, MLPDecoder, MLPEncoder
from ..dreamer_v3.agent import Actor, Decoder, Encoder, PlayerDV3, PlayerState, WorldModel, _dtype

__all__ = ["PlayerDV1", "RSSMV1", "RecurrentModel", "build_models", "compute_stochastic_state"]


def compute_stochastic_state(state_information: torch.Tensor, min_std: float = 0.1,
                             noise: torch.Tensor | None = None):
    """`[..., 2 S]` -> ((mean, std = softplus(raw) + min_std), the state): the
    mean when `noise` is None, else `mean + std * noise` (standard normals
    `[..., S]`)."""
    mean, std = state_information.chunk(2, dim=-1)
    std = F.softplus(std) + min_std
    return (mean, std), (mean if noise is None else mean + std * noise)


class RecurrentModel(tnn.Module):
    """Linear -> ELU -> `GRUCell`."""

    def __init__(self, input_size: int, recurrent_state_size: int, generator: torch.Generator | None = None):
        super().__init__()
        self.proj = Linear(input_size, recurrent_state_size, generator=generator)
        self.rnn = GRUCell(recurrent_state_size, recurrent_state_size, generator=generator)

    def forward(self, x: torch.Tensor, recurrent_state: torch.Tensor) -> torch.Tensor:
        return self.rnn(F.elu(self.proj(x)), recurrent_state)


class RSSMV1(tnn.Module):
    """The Gaussian RSSM: the representation and transition models emit
    `2 S` (mean, raw std) vectors."""

    def __init__(self, recurrent_model: RecurrentModel, representation_model: MLP, transition_model: MLP,
                 min_std: float = 0.1):
        super().__init__()
        self.recurrent_model = recurrent_model
        self.representation_model = representation_model
        self.transition_model = transition_model
        self.min_std = min_std

    def _representation(self, recurrent_state: torch.Tensor, embedded_obs: torch.Tensor,
                        noise: torch.Tensor | None = None):
        """-> ((mean, std) in f32, the posterior in the compute dtype)."""
        raw = self.representation_model(torch.cat([recurrent_state, embedded_obs], dim=-1)).float()
        mean_std, state = compute_stochastic_state(raw, self.min_std, noise)
        return mean_std, state.to(recurrent_state.dtype)

    def _transition(self, recurrent_out: torch.Tensor, noise: torch.Tensor | None = None):
        """-> ((mean, std) in f32, the prior in the compute dtype)."""
        mean_std, state = compute_stochastic_state(self.transition_model(recurrent_out).float(), self.min_std, noise)
        return mean_std, state.to(recurrent_out.dtype)

    def dynamic(self, posterior: torch.Tensor, recurrent_state: torch.Tensor, action: torch.Tensor,
                embedded_obs: torch.Tensor, noise: torch.Tensor):
        """One dynamic-learning step; `noise` [B, S] draws the posterior (the
        prior's own sample is never used in training, so it is not drawn).
        -> (recurrent_state, posterior, (post_mean, post_std), (prior_mean,
        prior_std))."""
        recurrent_state = self.recurrent_model(torch.cat([posterior, action], dim=-1), recurrent_state)
        prior_mean_std, _ = self._transition(recurrent_state)
        posterior_mean_std, posterior = self._representation(recurrent_state, embedded_obs, noise)
        return recurrent_state, posterior, posterior_mean_std, prior_mean_std

    def scan_dynamic(self, posterior0: torch.Tensor, recurrent0: torch.Tensor, actions: torch.Tensor,
                     embedded_obs: torch.Tensor, noises: torch.Tensor, remat: str = "off"):
        """The dynamic-learning sequence as a loop over T: actions [T, B, A],
        embedded_obs [T, B, E], noises [T, B, S]; `remat` checkpoints each
        step (`ops/scan.py:checkpoint_body`). -> stacked (recurrent_states,
        posteriors, post_means, post_stds, prior_means, prior_stds), each
        [T, B, ...]."""
        post, rec = posterior0, recurrent0
        step = checkpoint_body(self.dynamic, remat)
        outs = []
        for t in range(actions.shape[0]):
            rec, post, (qm, qs), (pm, ps) = step(post, rec, actions[t], embedded_obs[t], noises[t])
            outs.append((rec, post, qm, qs, pm, ps))
        return tuple(torch.stack(o) for o in zip(*outs))

    def imagination(self, stochastic_state: torch.Tensor, recurrent_state: torch.Tensor, actions: torch.Tensor,
                    noise: torch.Tensor):
        """One imagined step: `noise` [N, S] draws the next prior.
        -> (imagined_prior [N, S], recurrent_state)."""
        recurrent_state = self.recurrent_model(torch.cat([stochastic_state, actions], dim=-1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, noise)
        return imagined_prior, recurrent_state


class PlayerDV1(PlayerDV3):
    """DreamerV3's player over the Gaussian state: a flat zero-initialized
    stochastic state of `stochastic_size`, drawn from standard normals
    (`discrete_size` is not read). A `noisy_step` row's first
    `stochastic_size` uniforms become the posterior's normals
    (`ops/distributions.py:standard_normal`)."""

    @property
    def device(self) -> torch.device:
        return self.rssm.recurrent_model.proj.weight.device

    def _state_width(self) -> int:
        return self.stochastic_size

    def _posterior_noise(self, rows: int, generator: torch.Generator | None) -> torch.Tensor:
        return torch.randn((rows, self.stochastic_size), generator=generator, device=self.device)

    def _posterior_from_uniform(self, u: torch.Tensor) -> torch.Tensor:
        return standard_normal(u)

    def init_states(self, n_envs: int) -> PlayerState:
        dt = _dtype(self.compute_dtype)
        zeros = lambda width: torch.zeros((n_envs, width), dtype=dt, device=self.device)  # noqa: E731
        return PlayerState(actions=zeros(sum(self.actions_dim)), recurrent_state=zeros(self.recurrent_state_size),
                           stochastic_state=zeros(self.stochastic_size))

    def _posterior(self, state: PlayerState, obs: dict, noise: torch.Tensor):
        dt = _dtype(self.compute_dtype)
        embedded = self.encoder({k: v.to(dt) for k, v in obs.items()})
        recurrent = self.rssm.recurrent_model(
            torch.cat([state.stochastic_state, state.actions], dim=-1), state.recurrent_state
        )
        _, stochastic = self.rssm._representation(recurrent, embedded, noise)
        return recurrent, stochastic, torch.cat([stochastic, recurrent], dim=-1)


def build_models(
    generator: torch.Generator,
    actions_dim: Sequence[int],
    is_continuous: bool,
    args,
    obs_space: dict,
    cnn_keys: Sequence[str],
    mlp_keys: Sequence[str],
) -> tuple[WorldModel, Actor, MLP]:
    """Build (world_model, actor, critic) on the CPU: no LayerNorm anywhere,
    the actor tanh-normal (continuous) or discrete, every Linear
    Kaiming-normal with zero bias (convolutions keep their init)."""
    g = generator
    latent_state_size = args.stochastic_size + args.recurrent_state_size
    cnn_encoder = mlp_encoder = cnn_decoder = mlp_decoder = None
    if cnn_keys:
        cnn_encoder = CNNEncoder(
            cnn_keys, input_channels=sum(obs_space[k].shape[-1] for k in cnn_keys),
            image_size=obs_space[cnn_keys[0]].shape[:2], channels_multiplier=args.cnn_channels_multiplier,
            layer_norm=False, activation=args.cnn_act, generator=g,
        )
    if mlp_keys:
        mlp_encoder = MLPEncoder(
            mlp_keys, input_dim=sum(obs_space[k].shape[0] for k in mlp_keys), mlp_layers=args.mlp_layers,
            dense_units=args.dense_units, layer_norm=False, activation=args.dense_act, generator=g,
        )
    encoder = Encoder(cnn_encoder, mlp_encoder)
    rssm = RSSMV1(
        RecurrentModel(int(sum(actions_dim)) + args.stochastic_size, args.recurrent_state_size, generator=g),
        representation_model=MLP(args.recurrent_state_size + encoder.output_dim, [args.hidden_size],
                                 args.stochastic_size * 2, act=args.dense_act, generator=g),
        transition_model=MLP(args.recurrent_state_size, [args.hidden_size], args.stochastic_size * 2,
                             act=args.dense_act, generator=g),
        min_std=args.min_std,
    )
    if cnn_keys:
        cnn_decoder = CNNDecoder(
            cnn_keys, output_channels=[obs_space[k].shape[-1] for k in cnn_keys],
            channels_multiplier=args.cnn_channels_multiplier, latent_state_size=latent_state_size,
            cnn_encoder_output_dim=cnn_encoder.output_dim, layer_norm=False, activation=args.cnn_act, generator=g,
        )
    if mlp_keys:
        mlp_decoder = MLPDecoder(
            mlp_keys, output_dims=[obs_space[k].shape[0] for k in mlp_keys], latent_state_size=latent_state_size,
            mlp_layers=args.mlp_layers, dense_units=args.dense_units, layer_norm=False, activation=args.dense_act,
            generator=g,
        )
    hidden = [args.dense_units] * args.mlp_layers
    world_model = WorldModel(
        encoder, rssm, Decoder(cnn_decoder, mlp_decoder),
        reward_model=MLP(latent_state_size, hidden, 1, act=args.dense_act, generator=g),
        continue_model=MLP(latent_state_size, hidden, 1, act=args.dense_act, generator=g),
    )
    actor = Actor(
        latent_state_size, actions_dim, is_continuous, init_std=args.actor_init_std, min_std=args.actor_min_std,
        dense_units=args.dense_units, dense_act=args.dense_act, mlp_layers=args.mlp_layers,
        distribution="tanh_normal" if is_continuous else "discrete", layer_norm=False, unimix=0.0, generator=g,
    )
    critic = MLP(latent_state_size, hidden, 1, act=args.dense_act, generator=g)
    for module in (world_model, actor, critic):
        init_kaiming_normal(module, g)
    return world_model, actor, critic
