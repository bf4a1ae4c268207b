"""DreamerV3 agent (the port of sheeprl_tpu/algos/dreamer_v3/agent.py): the
encoders and decoders, the RSSM (dynamic learning over a sequence and
imagination), the world model, the actor (discrete or continuous actions),
the environment-interaction `PlayerDV3`, and `build_models`.

Randomness is explicit: every sample takes injected noise (Gumbels, or the
uniforms a continuous draw maps; the parity tests feed the reference's own
draw) or a `torch.Generator`; the reference threads `jax.random` keys
instead. Convolutions are NHWC, as in
the reference.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn as tnn
import torch.nn.functional as F

from ...nn.blocks import CNN, MLP, DeCNN
from ...nn.inits import init_xavier
from ...nn.layers import ConvTranspose2d, LayerNorm, Linear
from ...nn.recurrent import LayerNormGRUCell
from ...ops.distributions import (
    Independent,
    Normal,
    OneHotCategorical,
    TanhNormal,
    TruncatedNormal,
    gumbel_noise,
    standard_normal,
    unimix_logits,
)
from ...ops.kernels.rssm import fused_rssm_step, fused_rssm_supported
from ...ops.math import symlog
from ...ops.scan import checkpoint_body

__all__ = [
    "BEST_OF",
    "Actor",
    "CNNDecoder",
    "CNNEncoder",
    "Decoder",
    "Encoder",
    "MLPDecoder",
    "MLPEncoder",
    "PlayerDV3",
    "PlayerState",
    "RSSM",
    "RecurrentModel",
    "WorldModel",
    "build_models",
    "compute_stochastic_state",
    "exploration_actions",
]


# the samples a continuous actor draws in evaluation, keeping the likeliest
# (the reference's agent.py:670-674)
BEST_OF = 100


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


class CNNDecoder(tnn.Module):
    """Inverse of CNNEncoder: latent -> Linear -> [4, 4, 8m] -> 4 deconv
    stages -> 64x64 image dict, `+ 0.5` output shift. The last stage keeps
    its bias and has no norm (it stays plain PyTorch, as in the
    reference)."""

    def __init__(self, keys: Sequence[str], output_channels: Sequence[int], channels_multiplier: int,
                 latent_state_size: int, cnn_encoder_output_dim: int, *, layer_norm: bool = True,
                 activation: str = "silu", generator: torch.Generator | None = None):
        super().__init__()
        self.keys = tuple(keys)
        self.output_channels = tuple(output_channels)
        self.proj = Linear(latent_state_size, cnn_encoder_output_dim, generator=generator)
        self.model = DeCNN(
            8 * channels_multiplier, [channels_multiplier * m for m in (4, 2, 1)] + [sum(output_channels)],
            kernel_sizes=[4] * 4, strides=[2] * 4, act=activation, layer_norm=layer_norm,
            use_bias=not layer_norm, norm_eps=1e-3, generator=generator,
        )
        if layer_norm:
            last = self.model.layers[-1]
            self.model.layers[-1] = ConvTranspose2d(
                last.in_channels, last.out_channels, 4, stride=2, padding="SAME", use_bias=True,
                generator=generator,
            )

    def forward(self, latent: torch.Tensor) -> dict:
        x = self.proj(latent)
        x = x.reshape(*x.shape[:-1], 4, 4, -1)
        img = self.model(x) + 0.5
        return dict(zip(self.keys, torch.split(img, list(self.output_channels), dim=-1)))


class MLPDecoder(tnn.Module):
    """Per-key vector reconstruction heads over a shared MLP trunk."""

    def __init__(self, keys: Sequence[str], output_dims: Sequence[int], latent_state_size: int, *,
                 mlp_layers: int = 4, dense_units: int = 512, layer_norm: bool = True,
                 activation: str = "silu", generator: torch.Generator | None = None):
        super().__init__()
        self.keys = tuple(keys)
        self.model = MLP(
            latent_state_size, [dense_units] * mlp_layers, act=activation, layer_norm=layer_norm,
            use_bias=not layer_norm, norm_eps=1e-3, generator=generator,
        )
        self.heads = tnn.ModuleDict(
            {k: Linear(dense_units, dim, generator=generator) for k, dim in zip(keys, output_dims)}
        )

    def forward(self, latent: torch.Tensor) -> dict:
        x = self.model(latent)
        return {k: self.heads[k](x) for k in self.keys}


class Decoder(tnn.Module):
    """The observation model: merges per-key CNN and MLP reconstructions."""

    def __init__(self, cnn_decoder: CNNDecoder | None, mlp_decoder: MLPDecoder | None):
        super().__init__()
        self.cnn_decoder = cnn_decoder
        self.mlp_decoder = mlp_decoder

    def forward(self, latent: torch.Tensor) -> dict:
        out: dict = {}
        for d in (self.cnn_decoder, self.mlp_decoder):
            if d is not None:
                out.update(d(latent))
        return out


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
    """Recurrent State-Space Model with discrete (S x D) stochastic state,
    1% unimix and `is_first` episode-boundary resets."""

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

    def _fused_step_weights(self, dtype: torch.dtype):
        """The fused step's (weights, act, eps) when this RSSM's structure
        matches the kernel's contract, else None: the unfused branch serves
        (the reference's `_fused_step_weights`, agent.py:384-443). Contract:
        one hidden LayerNorm layer without bias in each of the three MLPs,
        head biases present, a bias-free LayerNorm-GRU, one shared
        activation, and a weight set within `fused_rssm_supported`'s
        budget. The six matrices are cast to `dtype` (a differentiable
        cast: the gradients reach the f32 parameters), the LN affines and
        head biases stay f32. The structure and the byte count decide,
        never the device."""
        rm, tm, pm = self.recurrent_model, self.transition_model, self.representation_model
        mlp, rnn = getattr(rm, "mlp", None), getattr(rm, "rnn", None)
        if mlp is None or rnn is None:
            return None

        def one_hidden(m) -> bool:
            norm = m.norms[0] if len(m.norms) else None
            return (len(m.layers) == 1 and isinstance(norm, LayerNorm) and norm.scale is not None
                    and m.layers[0].bias is None)

        if not (one_hidden(mlp) and one_hidden(tm) and one_hidden(pm)):
            return None
        if mlp.head is not None or tm.head is None or pm.head is None:
            return None
        if tm.head.bias is None or pm.head.bias is None:
            return None
        norm = rnn.norm
        if norm is None or norm.scale is None or rnn.proj.bias is not None:
            return None
        if not (mlp.act == tm.act == pm.act):
            return None
        weights = (
            mlp.layers[0].weight.to(dtype), mlp.norms[0].scale, mlp.norms[0].offset,
            rnn.proj.weight.to(dtype), norm.scale, norm.offset,
            tm.layers[0].weight.to(dtype), tm.norms[0].scale, tm.norms[0].offset,
            tm.head.weight.to(dtype), tm.head.bias,
            pm.layers[0].weight.to(dtype), pm.norms[0].scale, pm.norms[0].offset,
            pm.head.weight.to(dtype), pm.head.bias,
        )
        act = mlp.act or "identity"
        if not fused_rssm_supported(act, *weights):
            return None
        return weights, act, (mlp.norms[0].eps, norm.eps, tm.norms[0].eps)

    def _reset(self, posterior: torch.Tensor, recurrent_state: torch.Tensor, action: torch.Tensor,
               is_first: torch.Tensor):
        """The `is_first` resets in the compute dtype: the action and the
        recurrent state zeroed, the posterior re-seeded from the transition
        prior's mode. -> (the recurrent model's input [posterior_flat,
        action], the recurrent state)."""
        dt = recurrent_state.dtype
        is_first = is_first.to(dt)
        action = (1.0 - is_first) * action.to(dt)
        recurrent_state = (1.0 - is_first) * recurrent_state
        posterior_flat = posterior.to(dt).reshape(*posterior.shape[:-2], -1)
        init_post = self._transition(recurrent_state)[1].reshape(posterior_flat.shape)
        posterior_flat = (1.0 - is_first) * posterior_flat + is_first * init_post
        return torch.cat([posterior_flat, action], dim=-1), recurrent_state

    def dynamic(self, posterior: torch.Tensor, recurrent_state: torch.Tensor, action: torch.Tensor,
                embedded_obs: torch.Tensor, is_first: torch.Tensor, gumbel: torch.Tensor,
                fused=False):
        """One dynamic-learning step: where `is_first`, the action and
        recurrent state are zeroed and the posterior is re-seeded from the
        transition prior's mode. `gumbel` [B, S, D] draws the posterior. The
        prior's own sample is never used in training, so it is not drawn.
        When `_fused_step_weights` admits this RSSM, the recurrent model and
        both heads run as one `fused_rssm_step` (the reference's fused
        branch, agent.py:469-485); the `is_first` arithmetic and the
        unimix/sampling stay outside it. `fused` takes that method's result
        when the caller has it already (`scan_dynamic` casts the weights
        once for the whole sequence). -> (recurrent_state, posterior
        [B, S, D], prior_logits, posterior_logits)."""
        dt = recurrent_state.dtype
        x, recurrent_state = self._reset(posterior, recurrent_state, action, is_first)
        if fused is False:
            fused = self._fused_step_weights(dt) if x.dim() == 2 else None
        if fused is not None:
            weights, act, eps = fused
            recurrent_state, prior_raw, post_raw = fused_rssm_step(
                x, recurrent_state, embedded_obs, *weights, act, eps
            )
            prior_logits = self._uniform_mix(prior_raw)
            posterior_logits, posterior = self._mix_sample(post_raw, gumbel, dt)
            return recurrent_state, posterior, prior_logits, posterior_logits
        recurrent_state = self.recurrent_model(x, recurrent_state)
        prior_logits = self._uniform_mix(self.transition_model(recurrent_state).float())
        posterior_logits, posterior = self._representation(recurrent_state, embedded_obs, gumbel)
        return recurrent_state, posterior, prior_logits, posterior_logits

    def scan_dynamic(self, posterior0: torch.Tensor, recurrent0: torch.Tensor, actions: torch.Tensor,
                     embedded_obs: torch.Tensor, is_first: torch.Tensor, gumbels: torch.Tensor,
                     remat: str = "off"):
        """The dynamic-learning sequence as a loop over T (the reference's
        `lax.scan`): actions [T, B, A], embedded_obs [T, B, E], is_first
        [T, B, 1], gumbels [T, B, S, D]. The fused step's weights are cast
        to the compute dtype once, before the loop. `remat` checkpoints
        each step for the backward (`ops/scan.py:checkpoint_body`). Returns
        stacked (recurrent_states [T, B, R], priors_logits [T, B, S*D],
        posteriors [T, B, S, D], posteriors_logits [T, B, S*D])."""
        post, rec = posterior0, recurrent0
        fused = self._fused_step_weights(rec.dtype) if rec.dim() == 2 else None
        step = checkpoint_body(self.dynamic, remat)
        outs = []
        for t in range(actions.shape[0]):
            rec, post, prior_logits, post_logits = step(
                post, rec, actions[t], embedded_obs[t], is_first[t], gumbels[t], fused=fused
            )
            outs.append((rec, prior_logits, post, post_logits))
        return tuple(torch.stack(o) for o in zip(*outs))

    def imagination(self, prior: torch.Tensor, recurrent_state: torch.Tensor, actions: torch.Tensor,
                    gumbel: torch.Tensor):
        """One-step latent imagination: prior [N, S*D] flat, `gumbel`
        [N, S, D] draws the next prior. -> (imagined_prior [N, S*D],
        recurrent_state)."""
        recurrent_state = self.recurrent_model(torch.cat([prior, actions], dim=-1), recurrent_state)
        _, imagined_prior = self._transition(recurrent_state, gumbel)
        return imagined_prior.reshape(*imagined_prior.shape[:-2], -1), recurrent_state


class WorldModel(tnn.Module):
    """Encoder + RSSM + observation/reward/continue heads."""

    def __init__(self, encoder: Encoder, rssm: RSSM, observation_model: Decoder, reward_model: MLP,
                 continue_model: MLP):
        super().__init__()
        self.encoder = encoder
        self.rssm = rssm
        self.observation_model = observation_model
        self.reward_model = reward_model
        self.continue_model = continue_model


class Actor(tnn.Module):
    """DreamerV3 policy head: an MLP trunk, then one head per discrete action
    space (unimix one-hot categoricals) or, for continuous control, one head
    of 2 * sum(actions_dim) read as (mean, std) (the reference's
    agent.py:556-680): `trunc_normal`, the default for "auto"
    (TruncatedNormal(tanh(mean), 2 sigmoid((std + init_std) / 2) +
    min_std, -1, 1)), `tanh_normal` (TanhNormal(5 tanh(mean / 5),
    softplus(std + init_std) + min_std)) or `normal`. Training takes one
    straight-through (discrete) or reparameterized (continuous) sample;
    evaluation the mode (discrete) or the likeliest of `BEST_OF` samples
    (continuous). A continuous sample takes its uniforms as an argument
    (floats in [0, 1), `ops/distributions.py`); nothing is drawn inside."""

    def __init__(self, latent_state_size: int, actions_dim: Sequence[int], is_continuous: bool, *,
                 init_std: float = 0.0, min_std: float = 0.1, dense_units: int = 512,
                 dense_act: str = "silu", mlp_layers: int = 2, distribution: str = "auto",
                 layer_norm: bool = True, unimix: float = 0.01,
                 generator: torch.Generator | None = None):
        super().__init__()
        distribution = distribution.lower()
        if distribution not in ("auto", "normal", "tanh_normal", "discrete", "trunc_normal"):
            raise ValueError(f"unknown actor distribution {distribution!r}")
        if distribution == "discrete" and is_continuous:
            raise ValueError("discrete distribution chosen but action space is continuous")
        if distribution == "auto":
            distribution = "trunc_normal" if is_continuous else "discrete"
        self.actions_dim = tuple(int(d) for d in actions_dim)
        self.is_continuous = bool(is_continuous)
        self.distribution = distribution
        self.init_std = float(init_std)
        self.min_std = float(min_std)
        self.unimix = unimix
        self.model = MLP(
            latent_state_size, [dense_units] * mlp_layers, act=dense_act, layer_norm=layer_norm,
            use_bias=not layer_norm, norm_eps=1e-3, generator=generator,
        )
        widths = [2 * sum(self.actions_dim)] if self.is_continuous else self.actions_dim
        self.heads = tnn.ModuleList(Linear(dense_units, d, generator=generator) for d in widths)

    def dists(self, state: torch.Tensor) -> tuple:
        x = self.model(state)
        # distribution math runs in f32, whatever the trunk's dtype
        pre = [head(x).float() for head in self.heads]
        if self.is_continuous:
            mean, std = pre[0].chunk(2, dim=-1)
            if self.distribution == "tanh_normal":
                return (TanhNormal(5.0 * torch.tanh(mean / 5.0), F.softplus(std + self.init_std) + self.min_std),)
            if self.distribution == "normal":
                return (Independent(Normal(mean, std), 1),)
            std = 2.0 * torch.sigmoid((std + self.init_std) / 2.0) + self.min_std
            one = torch.ones_like(mean)
            return (Independent(TruncatedNormal(torch.tanh(mean), std, -one, one), 1),)
        return tuple(OneHotCategorical(unimix_logits(logits, self.unimix)) for logits in pre)

    def _sample(self, dist, uniforms: torch.Tensor) -> torch.Tensor:
        """A continuous actor's reparameterized draw from the floats
        `uniforms` (leading sample axes, then [..., A])."""
        if self.distribution == "tanh_normal":
            return dist.sample(uniforms)
        if self.distribution == "normal":
            return dist.base.loc + dist.base.scale * standard_normal(uniforms)
        return dist.base.sample(uniforms)

    def forward(self, state: torch.Tensor, is_training: bool = True,
                gumbels: Sequence[torch.Tensor] | None = None, uniforms: torch.Tensor | None = None):
        """-> (actions tuple, distributions tuple). Discrete heads: straight-
        through draws in training (with `gumbels`, one per head, when given),
        the mode in evaluation. Continuous: in training one sample from
        `uniforms` [N, A]; in evaluation `BEST_OF` samples from `uniforms`
        [BEST_OF, N, A], of which each row keeps the one with the largest
        log-probability (summed over the action axis)."""
        dists = self.dists(state)
        if self.is_continuous:
            if uniforms is None:
                raise ValueError("a continuous actor samples from given uniforms")
            d = dists[0]
            samples = self._sample(d, uniforms)
            if is_training:
                return (samples,), dists
            best = torch.argmax(d.log_prob(samples), dim=0)  # [N]
            index = best[None, :, None].expand(1, *samples.shape[1:])
            return (torch.gather(samples, 0, index)[0],), dists
        if is_training:
            gumbels = gumbels if gumbels is not None else [None] * len(dists)
            actions = tuple(d.rsample(g) for d, g in zip(dists, gumbels))
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
    actions: tuple[torch.Tensor, ...], is_continuous: bool, expl_amount,
    generator: torch.Generator | None = None, noise=None,
) -> torch.Tensor:
    """Add exploration noise and concatenate the per-head actions: for
    continuous control `clip(a + expl_amount * n, -1, 1)` with `noise` the
    standard normals `n` ([N, A]) when given, else drawn from `generator`
    (the reference's agent.py:755-758); an epsilon-uniform one-hot swap per
    discrete head, which takes its draws from `noise` (per head, uniform [N]
    for the swapped-in index and uniform [N] for the swap), else from
    `generator`. Every row takes the same arithmetic whatever the amount (no
    branch on it, so `expl_amount` may be a device scalar and a CUDA graph
    of the step serves every amount, 0 included)."""
    if is_continuous:
        cat = torch.cat(actions, dim=-1)
        if noise is None:
            noise = torch.randn(cat.shape, generator=generator, device=cat.device, dtype=cat.dtype)
        return torch.clamp(cat + expl_amount * noise, -1.0, 1.0)
    if noise is None:
        noise = [tuple(torch.rand((2, *act.shape[:-1]), generator=generator, device=act.device)) for act in actions]
    out = []
    for act, (u_idx, u_take) in zip(actions, noise):
        n = act.shape[-1]
        rand_idx = (u_idx * n).long().clamp_max(n - 1)
        rand_one_hot = F.one_hot(rand_idx, n).to(act.dtype)
        out.append(torch.where((u_take < expl_amount)[..., None], rand_one_hot, act))
    return torch.cat(out, dim=-1)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """`ops.distributions.gumbel_noise`'s transform of uniform draws."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


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

    def reset_states(self, state: PlayerState, reset_mask: torch.Tensor) -> PlayerState:
        """Re-initialize the rows where `reset_mask` ([N] bool/float) is set."""
        m = reset_mask.reshape(-1, 1).to(state.recurrent_state.dtype)
        fresh = self.init_states(state.actions.shape[0])
        return PlayerState(
            actions=(1 - m) * state.actions + m * fresh.actions,
            recurrent_state=(1 - m) * state.recurrent_state + m * fresh.recurrent_state,
            stochastic_state=(1 - m) * state.stochastic_state + m * fresh.stochastic_state,
        )

    def _posterior(self, state: PlayerState, obs: dict, gumbel: torch.Tensor):
        """The recurrent state, the posterior drawn with `gumbel` [N, S, D]
        (flat [N, S*D]) and their latent, from the compute-dtype obs."""
        dt = _dtype(self.compute_dtype)
        embedded = self.encoder({k: v.to(dt) for k, v in obs.items()})
        recurrent = self.rssm.recurrent_model(
            torch.cat([state.stochastic_state, state.actions], dim=-1), state.recurrent_state
        )
        _, stochastic = self.rssm._representation(recurrent, embedded, gumbel)
        stochastic = stochastic.reshape(*stochastic.shape[:-2], -1)
        return recurrent, stochastic, torch.cat([stochastic, recurrent], dim=-1)

    def _state_width(self) -> int:
        """The stochastic state's flat width (S * D one-hot rows)."""
        return self.stochastic_size * self.discrete_size

    def _posterior_noise(self, rows: int, generator: torch.Generator | None) -> torch.Tensor:
        """The posterior's draw for `rows` rows from `generator`: Gumbels [rows, S, D]."""
        return gumbel_noise((rows, self.stochastic_size, self.discrete_size), generator, self.device)

    def _posterior_from_uniform(self, u: torch.Tensor) -> torch.Tensor:
        """The posterior's draw from uniform floats [rows, S * D]: Gumbels [rows, S, D]."""
        return _gumbel(u).reshape(u.shape[0], self.stochastic_size, self.discrete_size)

    def step(self, state: PlayerState, obs: dict, gumbel: torch.Tensor | None = None,
             generator: torch.Generator | None = None,
             uniforms: torch.Tensor | None = None) -> tuple[PlayerState, torch.Tensor]:
        """One greedy action step, no exploration (the served step, and the
        test episodes' greedy play): a discrete actor's mode, or a
        continuous actor's likeliest of `BEST_OF` samples drawn from
        `uniforms` ([BEST_OF, N, A] floats in [0, 1)) and clipped to
        [-1, 1], as the reference's zero-amount exploration clips. The
        posterior is sampled with `gumbel` ([N, S, D]) when given; whatever
        is not given is drawn from `generator`, the posterior's noise first.
        Sampled actions take `noisy_step`. Returns (new_state, actions [N,
        sum(actions_dim)])."""
        dt = _dtype(self.compute_dtype)
        rows = state.recurrent_state.shape[0]
        if gumbel is None:
            gumbel = self._posterior_noise(rows, generator)
        if self.is_continuous and uniforms is None:
            uniforms = torch.rand((BEST_OF, rows, sum(self.actions_dim)), generator=generator, device=self.device)
        recurrent, stochastic, latent = self._posterior(state, obs, gumbel)
        actions, _ = self.actor(latent, is_training=False, uniforms=uniforms)
        cat = torch.cat(actions, dim=-1)
        if self.is_continuous:
            cat = torch.clamp(cat, -1.0, 1.0)
        return PlayerState(actions=cat.to(dt), recurrent_state=recurrent, stochastic_state=stochastic), cat

    def noise_width(self) -> int:
        """The uniform draws a row of `noisy_step` takes: the posterior's
        S*D Gumbels, then for discrete heads one Gumbel an action and two
        exploration draws a head, for continuous actions the actor's A
        uniforms and A exploration draws."""
        a = sum(self.actions_dim)
        tail = 2 * a if self.is_continuous else a + 2 * len(self.actions_dim)
        return self._state_width() + tail

    def draw_noise(self, n: int, generator: torch.Generator, device) -> torch.Tensor:
        """One `noisy_step`'s randomness for `n` rows: uniform [n, noise_width] in one draw."""
        return torch.rand((n, self.noise_width()), generator=generator, device=device)

    def noisy_step(self, state: PlayerState, obs: dict, uniform: torch.Tensor,
                   expl_amount: torch.Tensor) -> tuple[PlayerState, torch.Tensor]:
        """A step with sampled actions and all its randomness given, so it
        can be replayed as one CUDA graph: `uniform` from `draw_noise` (the
        posterior's Gumbels; then the actor's Gumbel-max draws and each
        discrete head's exploration draws, or the continuous actor's
        uniforms [N, A] and the exploration's normals [N, A] as uniforms,
        `ops/distributions.py:standard_normal`) and `expl_amount` a device
        scalar (the training loop's decaying amount; 0 in the test episodes
        that sample). Returns (new_state, actions [N, sum(actions_dim)])."""
        dt = _dtype(self.compute_dtype)
        sd, a = self._state_width(), sum(self.actions_dim)
        recurrent, stochastic, latent = self._posterior(state, obs, self._posterior_from_uniform(uniform[:, :sd]))
        if self.is_continuous:
            actions, _ = self.actor(latent, is_training=True, uniforms=uniform[:, sd:sd + a])
            noise = standard_normal(uniform[:, sd + a:sd + 2 * a])
        else:
            head_gumbels = torch.split(_gumbel(uniform[:, sd:sd + a]), list(self.actions_dim), dim=-1)
            actions, _ = self.actor(latent, is_training=True, gumbels=head_gumbels)
            draws = uniform[:, sd + a:]
            noise = [(draws[:, 2 * i], draws[:, 2 * i + 1]) for i in range(len(self.actions_dim))]
        cat = exploration_actions(actions, self.is_continuous, expl_amount, noise=noise)
        return PlayerState(actions=cat.to(dt), recurrent_state=recurrent, stochastic_state=stochastic), cat


def build_models(
    generator: torch.Generator,
    actions_dim: Sequence[int],
    is_continuous: bool,
    args,
    obs_space: dict,
    cnn_keys: Sequence[str],
    mlp_keys: Sequence[str],
) -> tuple[WorldModel, Actor, MLP, MLP]:
    """Build (world_model, actor, critic, target_critic) on the CPU with the
    Hafner initialization pass: Xavier-normal everywhere; Xavier-uniform on
    the distribution output layers (actor heads, transition and
    representation heads, continue head, the decoders' output layers);
    zeros on the reward and critic heads. The target critic is a deep copy
    of the critic."""
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
    cnn_decoder = None
    if cnn_keys:
        cnn_decoder = CNNDecoder(
            cnn_keys, output_channels=[obs_space[k].shape[-1] for k in cnn_keys],
            channels_multiplier=args.cnn_channels_multiplier, latent_state_size=latent_state_size,
            cnn_encoder_output_dim=cnn_encoder.output_dim, layer_norm=args.layer_norm,
            activation=args.cnn_act, generator=g,
        )
    mlp_decoder = None
    if mlp_keys:
        mlp_decoder = MLPDecoder(
            mlp_keys, output_dims=[obs_space[k].shape[0] for k in mlp_keys],
            latent_state_size=latent_state_size, mlp_layers=args.mlp_layers,
            dense_units=args.dense_units, layer_norm=args.layer_norm, activation=args.dense_act,
            generator=g,
        )
    hidden = [args.dense_units] * args.mlp_layers
    world_model = WorldModel(
        encoder, rssm, Decoder(cnn_decoder, mlp_decoder),
        reward_model=MLP(latent_state_size, hidden, args.bins, **mlp_kwargs),
        continue_model=MLP(latent_state_size, hidden, 1, **mlp_kwargs),
    )
    actor = Actor(
        latent_state_size, actions_dim, is_continuous, init_std=args.actor_init_std,
        min_std=args.actor_min_std, dense_units=args.dense_units, dense_act=args.dense_act,
        mlp_layers=args.mlp_layers, distribution=args.actor_distribution,
        layer_norm=args.layer_norm, unimix=args.unimix, generator=g,
    )
    critic = MLP(latent_state_size, hidden, args.bins, **mlp_kwargs)
    for module in (world_model, actor, critic):
        init_xavier(module, g, "normal")
    if args.hafner_initialization:
        for head in actor.heads:
            init_xavier(head, g, "uniform")
        init_xavier(critic.head, g, "zero")
        init_xavier(rssm.transition_model.head, g, "uniform")
        init_xavier(rssm.representation_model.head, g, "uniform")
        init_xavier(world_model.reward_model.head, g, "zero")
        init_xavier(world_model.continue_model.head, g, "uniform")
        if mlp_decoder is not None:
            for k in sorted(mlp_decoder.heads):
                init_xavier(mlp_decoder.heads[k], g, "uniform")
        if cnn_decoder is not None:
            init_xavier(cnn_decoder.model.layers[-1], g, "uniform")
    return world_model, actor, critic, copy.deepcopy(critic)
