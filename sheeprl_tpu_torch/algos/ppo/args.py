"""PPO config (the port of sheeprl_tpu/algos/ppo/args.py: the same fields
and defaults, without those of the mesh, the flock, DIAMBRA, Atari and
video capture, which the port does not have)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ...utils.parser import Arg
from ..args import StandardArgs


@dataclasses.dataclass
class PPOArgs(StandardArgs):
    per_rank_batch_size: int = Arg(default=64, help="minibatch size")
    total_steps: int = Arg(default=2**16, help="total env steps of the experiment")
    rollout_steps: int = Arg(default=128, help="env steps per policy rollout")
    mask_vel: bool = Arg(default=False, help="mask velocity entries (POMDP)")
    lr: float = Arg(default=1e-3, help="optimizer learning rate")
    anneal_lr: bool = Arg(default=False, help="linearly anneal lr to zero")
    gamma: float = Arg(default=0.99, help="discount factor")
    gae_lambda: float = Arg(default=0.95, help="GAE lambda")
    update_epochs: int = Arg(default=10, help="epochs over the rollout per update")
    loss_reduction: str = Arg(default="mean", help="loss reduction: mean|sum")
    normalize_advantages: bool = Arg(default=False, help="normalize advantages per minibatch")
    clip_coef: float = Arg(default=0.2, help="surrogate clipping coefficient")
    anneal_clip_coef: bool = Arg(default=False, help="anneal clip coefficient to zero")
    clip_vloss: bool = Arg(default=False, help="clip the value loss")
    ent_coef: float = Arg(default=0.0, help="entropy bonus coefficient")
    anneal_ent_coef: bool = Arg(default=False, help="anneal entropy coefficient to zero")
    vf_coef: float = Arg(default=1.0, help="value loss coefficient")
    max_grad_norm: float = Arg(default=0.0, help="global grad-norm clip; 0 disables")
    dense_units: int = Arg(default=64, help="units per dense layer")
    actor_hidden_size: Optional[int] = Arg(
        default=None, help="units per actor-backbone layer; falls back to dense_units"
    )
    critic_hidden_size: Optional[int] = Arg(
        default=None, help="units per critic layer; falls back to dense_units"
    )
    cnn_channels_multiplier: int = Arg(
        default=1, help="NatureCNN width multiplication factor, must be greater than zero"
    )
    mlp_layers: int = Arg(default=2, help="MLP depth for actor/critic/backbone")
    dense_act: str = Arg(default="tanh", help="dense activation name")
    layer_norm: bool = Arg(default=False, help="LayerNorm after every dense layer")
    grayscale_obs: bool = Arg(default=False, help="grayscale image observations")
    cnn_keys: Optional[List[str]] = Arg(default=None, help="obs keys for the CNN encoder")
    mlp_keys: Optional[List[str]] = Arg(default=None, help="obs keys for the MLP encoder")
    eps: float = Arg(default=1e-4, help="adam epsilon")
    cnn_features_dim: int = Arg(default=512, help="CNN encoder output features")
    mlp_features_dim: int = Arg(default=64, help="MLP encoder output features")
