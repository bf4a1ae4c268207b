"""Plan2Explore-on-DreamerV2 models (the port of
sheeprl_tpu/algos/p2e_dv2/agent.py): the DreamerV2 world model, two
actor-critics (exploration and task), each with a hard-copied target
critic, and an ensemble predicting the next posterior from (action,
recurrent state, posterior), whose disagreement is the intrinsic reward.
The ensemble is one stacked MLP (`algos/p2e_dv1/agent.py`). No kernel
takes any of it (DreamerV2's guards, `algos/dreamer_v2/agent.py`; the
members are plain MLPs)."""

from __future__ import annotations

import copy
from typing import Sequence

import torch

from ...nn.blocks import MLP, StackedMLP
from ...nn.inits import init_xavier
from ..dreamer_v2.agent import build_models as dv2_build_models
from ..dreamer_v3.agent import Actor, WorldModel
from ..p2e_dv1.agent import build_ensembles, ensemble_apply

__all__ = ["build_ensembles", "build_models", "ensemble_apply"]


def build_models(
    generator: torch.Generator,
    actions_dim: Sequence[int],
    is_continuous: bool,
    args,
    obs_space: dict,
    cnn_keys: Sequence[str],
    mlp_keys: Sequence[str],
) -> tuple[WorldModel, Actor, MLP, MLP, Actor, MLP, MLP, StackedMLP]:
    """-> (world_model, actor_task, critic_task, target_critic_task,
    actor_exploration, critic_exploration, target_critic_exploration,
    ensembles) on the CPU: DreamerV2's models are the world model and the
    exploration behaviour; the task actor (unimix 0) and critic are
    Xavier-normal, each target critic a copy of its critic, and the
    ensemble's members Xavier-normal MLPs from (action, recurrent state,
    posterior) to the next posterior's S * D logits."""
    g = generator
    world_model, actor_exploration, critic_exploration, target_critic_exploration = dv2_build_models(
        g, actions_dim, is_continuous, args, obs_space, cnn_keys, mlp_keys)
    stochastic_size = args.stochastic_size * args.discrete_size
    latent_state_size = stochastic_size + args.recurrent_state_size
    hidden = [args.dense_units] * args.mlp_layers
    actor_task = Actor(
        latent_state_size, actions_dim, is_continuous, init_std=args.actor_init_std, min_std=args.actor_min_std,
        dense_units=args.dense_units, dense_act=args.dense_act, mlp_layers=args.mlp_layers,
        distribution=args.actor_distribution, layer_norm=args.layer_norm, unimix=0.0, generator=g,
    )
    critic_task = MLP(latent_state_size, hidden, 1, act=args.dense_act, layer_norm=args.layer_norm, generator=g)
    for module in (actor_task, critic_task):
        init_xavier(module, g, "normal")
    ensembles = build_ensembles(
        args.num_ensembles, int(sum(actions_dim)) + args.recurrent_state_size + stochastic_size, hidden,
        stochastic_size, act=args.dense_act, layer_norm=args.layer_norm, init="xavier_normal", generator=g,
    )
    return (world_model, actor_task, critic_task, copy.deepcopy(critic_task), actor_exploration, critic_exploration,
            target_critic_exploration, ensembles)
