"""DroQ config (the port of sheeprl_tpu/algos/droq/args.py: SAC's fields,
critic dropout and a high update-to-data ratio)."""

from __future__ import annotations

import dataclasses

from ...utils.parser import Arg
from ..sac.args import SACArgs


@dataclasses.dataclass
class DROQArgs(SACArgs):
    dropout: float = Arg(default=0.01, help="critic dropout probability")
    gradient_steps: int = Arg(default=20, help="gradient steps per env interaction (high UTD)")
