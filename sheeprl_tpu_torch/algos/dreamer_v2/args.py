"""DreamerV2 config — the base of the Dreamer-family inheritance chain (the
port of sheeprl_tpu/algos/dreamer_v2/args.py, keeping the fields that
build, train and run DreamerV3; same defaults)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ...utils.parser import Arg
from ..args import StandardArgs


@dataclasses.dataclass
class DreamerV2Args(StandardArgs):
    def __setattr__(self, name, value):
        if name == "remat" and value not in ("off", "on", "policy", "auto"):
            raise ValueError(f"remat must be 'off', 'on', 'policy' or 'auto', got {value!r}")
        super().__setattr__(name, value)

    env_id: str = Arg(default="dmc_walker_walk", help="the id of the environment")

    # Experiment settings
    per_rank_batch_size: int = Arg(default=16, help="the batch size for each rank")
    per_rank_sequence_length: int = Arg(default=50, help="the sequence length for each rank")
    total_steps: int = Arg(default=int(5e6), help="total timesteps of the experiments")
    buffer_size: int = Arg(default=int(5e6), help="the size of the buffer")
    learning_starts: int = Arg(default=int(1e3), help="timestep to start learning")
    pretrain_steps: int = Arg(default=100, help="the number of pretrain steps")
    gradient_steps: int = Arg(default=1, help="the number of gradient steps per each environment interaction")
    train_every: int = Arg(default=5, help="the number of steps between one training and another")
    # the reference's DreamerV1Args field, which its v2 and v3 inherit
    checkpoint_buffer: bool = Arg(default=False, help="whether or not to save the buffer during the checkpoint")

    # Agent settings
    world_lr: float = Arg(default=3e-4, help="world model learning rate")
    actor_lr: float = Arg(default=8e-5, help="actor learning rate")
    critic_lr: float = Arg(default=8e-5, help="critic learning rate")
    horizon: int = Arg(default=15, help="the number of imagination steps")
    gamma: float = Arg(default=0.99, help="the discount factor gamma")
    lmbda: float = Arg(default=0.95, help="the lambda for the TD lambda values")
    kl_free_nats: float = Arg(default=1.0, help="the minimum value for the kl divergence")
    kl_regularizer: float = Arg(default=1.0, help="the scale factor for the kl divergence")
    continue_scale_factor: float = Arg(default=1.0, help="the scale factor for the continue loss")
    actor_ent_coef: float = Arg(default=1e-4, help="the entropy coefficient for the actor loss")
    actor_init_std: float = Arg(
        default=0.0, help="the amount to sum to the input of the std function of the actions"
    )
    actor_min_std: float = Arg(default=0.1, help="the minimum standard deviation for the actions")
    critic_target_network_update_freq: int = Arg(default=100, help="target critic update frequency")
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
    remat: str = Arg(
        default="off",
        help="recompute the RSSM scan and imagination step bodies on backward "
        "(torch.utils.checkpoint): 'on' a full checkpoint of each step, 'policy' keeps the matrix "
        "products' outputs and recomputes the rest, 'auto' runs the measured decision "
        "(compile/decisions.py:decide_remat: fewer peak bytes at <=5%% more time, bit-exact "
        "gradients) before the first step",
    )

    # Environment settings
    expl_amount: float = Arg(default=0.0, help="the exploration amount to add to the actions")
    expl_decay: bool = Arg(default=False, help="whether or not to decrement the exploration amount")
    expl_min: float = Arg(default=0.0, help="the minimum value for the exploration amount")
    max_step_expl_decay: int = Arg(default=0, help="the maximum number of decay steps")
    clip_rewards: bool = Arg(default=False, help="whether or not to clip rewards using tanh")
    grayscale_obs: bool = Arg(default=False, help="whether the observations are grayscale")
    cnn_keys: Optional[List[str]] = Arg(default=None, help="observation keys for the CNN encoder")
    mlp_keys: Optional[List[str]] = Arg(default=None, help="observation keys for the MLP encoder")
