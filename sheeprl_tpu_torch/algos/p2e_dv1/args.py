"""Plan2Explore-on-DreamerV1 config (the port of
sheeprl_tpu/algos/p2e_dv1/args.py: its fields and defaults)."""

from __future__ import annotations

import dataclasses

from ...utils.parser import Arg
from ..dreamer_v1.args import DreamerV1Args


@dataclasses.dataclass
class P2EDV1Args(DreamerV1Args):
    # overrides
    stochastic_size: int = Arg(default=60, help="the dimension of the stochastic state")
    hidden_size: int = Arg(default=400, help="hidden size for the transition and representation model")
    recurrent_state_size: int = Arg(default=400, help="the dimension of the recurrent state")

    # P2E args
    num_ensembles: int = Arg(default=10, help="number of ensembles for the intrinsic reward")
    ensemble_lr: float = Arg(default=3e-4, help="ensemble learning rate")
    ensemble_eps: float = Arg(default=1e-5, help="ensemble Adam epsilon")
    ensemble_clip_gradients: float = Arg(default=100, help="ensemble gradient norm clip")
    intrinsic_reward_multiplier: float = Arg(default=10000, help="intrinsic reward scale")
    exploration_steps: int = Arg(
        default=int(5e6),
        help="total exploration steps; past this the task actor is fine-tuned "
        "(zero-shot if it never ends)",
    )
