"""DreamerV3 config (the port of sheeprl_tpu/algos/dreamer_v3/args.py — same
inheritance chain DreamerV2Args -> DreamerV3Args, same defaults)."""

from __future__ import annotations

import dataclasses

from ...utils.parser import Arg
from ..dreamer_v2.args import DreamerV2Args


@dataclasses.dataclass
class DreamerV3Args(DreamerV2Args):
    env_id: str = Arg(default="dmc_walker_walk", help="the id of the environment")

    # Agent settings
    hidden_size: int = Arg(default=512, help="hidden size of the transition/representation models")
    recurrent_state_size: int = Arg(default=512, help="the dimension of the recurrent state")
    dense_units: int = Arg(default=512, help="the number of units in dense layers")
    mlp_layers: int = Arg(default=2, help="MLP layers of actor/critic/continue/reward")
    cnn_channels_multiplier: int = Arg(default=32, help="cnn width multiplication factor")
    dense_act: str = Arg(default="silu", help="activation for the dense layers")
    cnn_act: str = Arg(default="silu", help="activation for the convolutional layers")
    layer_norm: bool = Arg(default=True, help="whether to apply LayerNorm after every layer")
    unimix: float = Arg(default=0.01, help="uniform mix for stochastic-state/action categoricals")
    hafner_initialization: bool = Arg(
        default=True,
        help="Hafner init: Xavier-normal everywhere, Xavier-uniform on distribution output "
        "layers (the critic/reward heads the reference zeroes are not part of the player)",
    )
