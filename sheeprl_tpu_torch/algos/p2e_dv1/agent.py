"""Plan2Explore-on-DreamerV1 models (the port of
sheeprl_tpu/algos/p2e_dv1/agent.py): the DreamerV1 world model, two
actor-critics (exploration and task, the task's learned zero-shot on the
reward model) and an ensemble of next-embedding predictors whose
disagreement is the intrinsic reward (arXiv:2005.05960).

The ensemble is one `nn/blocks.py:StackedMLP`, its members stacked on a
leading axis of every parameter (the reference's vmapped pytree, as the
SAC and DroQ critics): each layer is one batched product for all members.
No kernel takes any of it: the members are plain MLPs, and the rest is
DreamerV1's (`algos/dreamer_v1/agent.py`)."""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ...nn.blocks import MLP, StackedMLP
from ...nn.inits import init_kaiming_normal
from ...nn.layers import StackedLinear
from ..dreamer_v1.agent import build_models as dv1_build_models
from ..dreamer_v3.agent import Actor, WorldModel

__all__ = ["build_ensembles", "build_models", "ensemble_apply"]


def build_ensembles(num_ensembles: int, input_dim: int, hidden_sizes: Sequence[int], output_dim: int, *,
                    act: str, layer_norm: bool = False, init: str = "kaiming_normal",
                    generator: torch.Generator | None = None) -> StackedMLP:
    """`num_ensembles` MLPs of one shape as one `StackedMLP`, every member's
    Linear weights drawn independently by `init` ("kaiming_normal":
    N(0, 2 / in), DreamerV1's; "xavier_normal": N(0, 2 / (in + out)),
    DreamerV2's) and zero biases."""
    ensembles = StackedMLP(num_ensembles, input_dim, hidden_sizes, output_dim, act=act, layer_norm=layer_norm,
                           generator=generator)
    with torch.no_grad():
        for layer in ensembles.modules():
            if isinstance(layer, StackedLinear):
                _, fan_in, fan_out = layer.weight.shape
                var = 2.0 / fan_in if init == "kaiming_normal" else 2.0 / (fan_in + fan_out)
                layer.weight.normal_(0.0, math.sqrt(var), generator=generator)
                layer.bias.zero_()
    return ensembles


def ensemble_apply(ensembles: StackedMLP, x: torch.Tensor) -> torch.Tensor:
    """Every member on the same input `[..., in]` -> `[n, ..., out]` (the
    leading axes flattened into the rows of one batched product)."""
    lead = x.shape[:-1]
    y = ensembles(x.reshape(-1, x.shape[-1]))
    return y.reshape(y.shape[0], *lead, y.shape[-1])


def build_models(
    generator: torch.Generator,
    actions_dim: Sequence[int],
    is_continuous: bool,
    args,
    obs_space: dict,
    cnn_keys: Sequence[str],
    mlp_keys: Sequence[str],
) -> tuple[WorldModel, Actor, MLP, Actor, MLP, StackedMLP]:
    """-> (world_model, actor_task, critic_task, actor_exploration,
    critic_exploration, ensembles) on the CPU: DreamerV1's models are the
    world model and the exploration behaviour; the task actor
    (tanh-normal when continuous) and critic are Kaiming-normal, and so are
    the ensemble's ReLU members, from (action, recurrent state, posterior)
    to the encoder's embedding."""
    g = generator
    world_model, actor_exploration, critic_exploration = dv1_build_models(
        g, actions_dim, is_continuous, args, obs_space, cnn_keys, mlp_keys)
    latent_state_size = args.stochastic_size + args.recurrent_state_size
    actor_task = Actor(
        latent_state_size, actions_dim, is_continuous, init_std=args.actor_init_std, min_std=args.actor_min_std,
        dense_units=args.dense_units, dense_act=args.dense_act, mlp_layers=args.mlp_layers,
        distribution="tanh_normal" if is_continuous else "discrete", layer_norm=False, unimix=0.0, generator=g,
    )
    critic_task = MLP(latent_state_size, [args.dense_units] * args.mlp_layers, 1, act=args.dense_act, generator=g)
    for module in (actor_task, critic_task):
        init_kaiming_normal(module, g)
    ensembles = build_ensembles(
        args.num_ensembles, int(sum(actions_dim)) + args.recurrent_state_size + args.stochastic_size,
        [args.dense_units] * args.mlp_layers, world_model.encoder.output_dim, act="relu", init="kaiming_normal",
        generator=g,
    )
    return world_model, actor_task, critic_task, actor_exploration, critic_exploration, ensembles

