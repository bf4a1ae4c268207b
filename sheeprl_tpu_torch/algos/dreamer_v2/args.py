"""DreamerV2 config — the base of the Dreamer-family inheritance chain (the
port of sheeprl_tpu/algos/dreamer_v2/args.py, keeping the fields that
build and run the DreamerV3 player)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ...utils.parser import Arg
from ..args import StandardArgs


@dataclasses.dataclass
class DreamerV2Args(StandardArgs):
    env_id: str = Arg(default="dmc_walker_walk", help="the id of the environment")

    # Agent settings
    stochastic_size: int = Arg(default=32, help="the dimension of the stochastic state")
    discrete_size: int = Arg(default=32, help="the dimension of the discrete state")
    hidden_size: int = Arg(default=200, help="hidden size for the transition and representation model")
    recurrent_state_size: int = Arg(default=200, help="the dimension of the recurrent state")
    actor_distribution: str = Arg(
        default="auto",
        help="actor distribution: `auto`, `discrete`, `normal`, `tanh_normal` or `trunc_normal`",
    )
    dense_units: int = Arg(default=400, help="the number of units in dense layers")
    mlp_layers: int = Arg(default=4, help="the number of MLP layers of actor/critic/continue/reward")
    cnn_channels_multiplier: int = Arg(default=48, help="cnn width multiplication factor")
    dense_act: str = Arg(default="elu", help="activation for the dense layers")
    cnn_act: str = Arg(default="elu", help="activation for the convolutional layers")
    layer_norm: bool = Arg(default=False, help="whether to apply LayerNorm after every layer")

    # Environment settings
    grayscale_obs: bool = Arg(default=False, help="whether the observations are grayscale")
    cnn_keys: Optional[List[str]] = Arg(default=None, help="observation keys for the CNN encoder")
    mlp_keys: Optional[List[str]] = Arg(default=None, help="observation keys for the MLP encoder")
