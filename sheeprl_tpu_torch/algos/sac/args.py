"""SAC config (the port of sheeprl_tpu/algos/sac/args.py: the same fields
and defaults). The `sac` main parses it, and serving from `--model_argv`."""

from __future__ import annotations

import dataclasses

from ...utils.parser import Arg
from ..args import StandardArgs


@dataclasses.dataclass
class SACArgs(StandardArgs):
    env_id: str = Arg(default="Pendulum-v1", help="environment id (continuous actions)")
    total_steps: int = Arg(default=int(1e6), help="total env steps of the experiment")
    capture_video: bool = Arg(default=False, help="record videos of the agent")
    buffer_size: int = Arg(default=int(1e6), help="replay buffer capacity (global)")
    gamma: float = Arg(default=0.99, help="discount factor")
    tau: float = Arg(default=0.005, help="target network EMA coefficient")
    alpha: float = Arg(default=1.0, help="initial entropy temperature")
    per_rank_batch_size: int = Arg(default=256, help="replay batch size per device")
    learning_starts: int = Arg(default=100, help="env steps before learning starts")
    num_critics: int = Arg(default=2, help="critic ensemble size")
    q_lr: float = Arg(default=3e-4, help="critic learning rate")
    alpha_lr: float = Arg(default=3e-4, help="temperature learning rate")
    policy_lr: float = Arg(default=3e-4, help="actor learning rate")
    target_network_frequency: int = Arg(default=1, help="target EMA period in env steps")
    gradient_steps: int = Arg(default=1, help="gradient steps per env interaction")
    checkpoint_buffer: bool = Arg(default=False, help="include the replay buffer in checkpoints")
    sample_next_obs: bool = Arg(
        default=False,
        help="synthesize next observations from the buffer instead of storing them",
    )
    actor_hidden_size: int = Arg(default=256, help="actor MLP hidden width")
    critic_hidden_size: int = Arg(default=256, help="critic MLP hidden width")
