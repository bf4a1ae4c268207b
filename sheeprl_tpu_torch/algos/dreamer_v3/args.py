"""DreamerV3 config (the port of sheeprl_tpu/algos/dreamer_v3/args.py — same
inheritance chain DreamerV2Args -> DreamerV3Args, same defaults)."""

from __future__ import annotations

import dataclasses

from ...utils.parser import Arg
from ..dreamer_v2.args import DreamerV2Args


@dataclasses.dataclass
class DreamerV3Args(DreamerV2Args):
    env_id: str = Arg(default="dmc_walker_walk", help="the id of the environment")

    # Experiment settings
    per_rank_batch_size: int = Arg(default=16, help="the batch size for each rank")
    per_rank_sequence_length: int = Arg(default=64, help="the sequence length for each rank")
    total_steps: int = Arg(default=int(5e6), help="total timesteps of the experiments")
    buffer_size: int = Arg(default=int(1e6), help="the size of the buffer")
    learning_starts: int = Arg(default=1024, help="timestep to start learning")
    pretrain_steps: int = Arg(default=1, help="the number of pretrain steps")
    train_every: int = Arg(default=5, help="the number of steps between one training and another")
    checkpoint_every: int = Arg(default=-1, help="checkpoint period; -1 disables")

    # Agent settings
    world_lr: float = Arg(default=1e-4, help="world model learning rate")
    actor_lr: float = Arg(default=3e-5, help="actor learning rate")
    critic_lr: float = Arg(default=3e-5, help="critic learning rate")
    gamma: float = Arg(default=(1 - 1 / 333), help="the discount factor gamma")
    kl_dynamic: float = Arg(default=0.5, help="the regularizer for the KL dynamic loss")
    kl_representation: float = Arg(default=0.1, help="the regularizer for the KL representation loss")
    kl_free_nats: float = Arg(default=1.0, help="the minimum value for the kl divergence")
    actor_ent_coef: float = Arg(default=3e-4, help="the entropy coefficient for the actor loss")
    world_clip_gradients: float = Arg(default=1000.0, help="world model gradient norm clip")
    actor_clip_gradients: float = Arg(default=100.0, help="actor gradient norm clip")
    critic_clip_gradients: float = Arg(default=100.0, help="critic gradient norm clip")
    critic_target_network_update_freq: int = Arg(default=1, help="target critic update frequency")
    critic_tau: float = Arg(default=0.02, help="EMA tau: target = tau*critic + (1-tau)*target")
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
        "layers, zeros on the critic and reward heads",
    )

    # Environment settings
    action_repeat: int = Arg(default=4, help="the number of times an action is repeated")
    max_episode_steps: int = Arg(
        default=108000,
        help="max episode length in env steps (divided by action_repeat); -1 disables",
    )

    # Returns normalization (percentile EMA)
    moments_decay: float = Arg(default=0.99, help="EMA decay of the return-percentile normalizer")
    moment_max: float = Arg(default=1.0, help="max in `max(1/moment_max, Per(R,95) - Per(R,5))`")
    moments_percentile_low: float = Arg(default=0.05, help="lower percentile")
    moments_percentile_high: float = Arg(default=0.95, help="higher percentile")

    # Two-hot encoding bins
    bins: int = Arg(default=255, help="number of bins to two-hot-encode rewards and critic values")
