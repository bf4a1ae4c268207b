"""DreamerV1 config (the port of sheeprl_tpu/algos/dreamer_v1/args.py: its
fields and defaults). As in `algos/dreamer_v2/args.py`, the simulator
flags, `share_data`, `capture_video` and `envs_batch_size` (which the
reference declares and never reads) are accepted and read by nothing the
port runs, and `--seq_devices` takes 1."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ...utils.parser import Arg
from ..args import StandardArgs


@dataclasses.dataclass
class DreamerV1Args(StandardArgs):
    def __setattr__(self, name, value):
        if name == "remat" and value not in ("off", "on", "policy", "auto"):
            raise ValueError(f"remat must be 'off', 'on', 'policy' or 'auto', got {value!r}")
        super().__setattr__(name, value)

    seq_devices: int = Arg(
        default=1,
        help="devices on the time axis of the [T, B] world-model batch; the port has no mesh, so "
        "only 1 runs (a larger count raises)",
    )

    # Experiment settings
    share_data: bool = Arg(default=False, help="toggle sharing data between processes")
    per_rank_batch_size: int = Arg(default=50, help="the batch size for each rank")
    per_rank_sequence_length: int = Arg(default=50, help="the sequence length for each rank")
    total_steps: int = Arg(default=int(5e6), help="total timesteps of the experiments")
    capture_video: bool = Arg(default=False, help="whether to capture videos of the agent performances")
    buffer_size: int = Arg(default=int(5e6), help="the size of the buffer")
    learning_starts: int = Arg(default=int(5e3), help="timestep to start learning")
    gradient_steps: int = Arg(default=100, help="the number of gradient steps per each environment interaction")
    train_every: int = Arg(default=1000, help="the number of steps between one training and another")
    checkpoint_buffer: bool = Arg(default=False, help="whether or not to save the buffer during the checkpoint")

    # Agent settings
    world_lr: float = Arg(default=6e-4, help="world model learning rate")
    actor_lr: float = Arg(default=8e-5, help="actor learning rate")
    critic_lr: float = Arg(default=8e-5, help="critic learning rate")
    horizon: int = Arg(default=15, help="the number of imagination steps")
    gamma: float = Arg(default=0.99, help="the discount factor gamma")
    lmbda: float = Arg(default=0.95, help="the lambda for the TD lambda values")
    use_continues: bool = Arg(default=False, help="whether or not to use the continue predictor")
    stochastic_size: int = Arg(default=30, help="the dimension of the stochastic state")
    hidden_size: int = Arg(default=200, help="hidden size for the transition and representation model")
    recurrent_state_size: int = Arg(default=200, help="the dimension of the recurrent state")
    kl_free_nats: float = Arg(default=3.0, help="the minimum value for the kl divergence")
    kl_regularizer: float = Arg(default=1.0, help="the scale factor for the kl divergence")
    continue_scale_factor: float = Arg(default=10.0, help="the scale factor for the continue loss")
    min_std: float = Arg(default=0.1, help="minimum std of the stochastic state distribution")
    actor_mean_scale: float = Arg(default=5.0, help="scale factor for the actor mean squash")
    actor_init_std: float = Arg(default=5.0, help="the amount to sum inside the actor std softplus")
    actor_min_std: float = Arg(default=1e-4, help="the minimum standard deviation for the actions")
    clip_gradients: float = Arg(default=100.0, help="how much to clip the gradient norms")
    dense_units: int = Arg(default=400, help="the number of units in dense layers")
    mlp_layers: int = Arg(default=4, help="MLP layers of actor/critic/reward/continue")
    cnn_channels_multiplier: int = Arg(default=32, help="cnn width multiplication factor")
    dense_act: str = Arg(default="elu", help="activation for the dense layers")
    cnn_act: str = Arg(default="relu", help="activation for the convolutional layers")
    remat: str = Arg(
        default="off",
        help="recompute the RSSM scan and imagination step bodies on backward "
        "(torch.utils.checkpoint): 'on' a full checkpoint of each step, 'policy' keeps the matrix "
        "products' outputs and recomputes the rest, 'auto' runs the measured decision "
        "(compile/decisions.py:decide_remat: fewer peak bytes at <=5%% more time, bit-exact "
        "gradients) before the first step",
    )

    # Environment settings
    expl_amount: float = Arg(default=0.3, help="the exploration amount to add to the actions")
    expl_decay: bool = Arg(default=False, help="whether or not to decrement the exploration amount")
    expl_min: float = Arg(default=0.0, help="the minimum value for the exploration amount")
    max_step_expl_decay: int = Arg(default=0, help="the maximum number of decay steps")
    envs_batch_size: int = Arg(
        default=2,
        help="the number of environments batched per epoch (declared by the reference and read nowhere)",
    )
    action_repeat: int = Arg(default=2, help="the number of times an action is repeated")
    max_episode_steps: int = Arg(
        default=1000,
        help="max episode length in env steps (divided by action_repeat); -1 disables",
    )
    atari_noop_max: int = Arg(default=30, help="max no-op actions at reset of Atari envs")
    clip_rewards: bool = Arg(default=False, help="whether or not to clip rewards using tanh")
    grayscale_obs: bool = Arg(default=False, help="whether the observations are grayscale")
    cnn_keys: Optional[List[str]] = Arg(default=None, help="observation keys for the CNN encoder")
    mlp_keys: Optional[List[str]] = Arg(default=None, help="observation keys for the MLP encoder")
    mine_min_pitch: int = Arg(default=-60, help="minimum pitch in Minecraft environments")
    mine_max_pitch: int = Arg(default=60, help="maximum pitch in Minecraft environments")
    mine_start_position: Optional[List[str]] = Arg(
        default=None, help="starting position in Minecraft (x, y, z, pitch, yaw)"
    )
    minerl_dense: bool = Arg(default=False, help="whether the MineRL task has dense reward")
    minerl_extreme: bool = Arg(default=False, help="whether the MineRL task is extreme")
    mine_break_speed: int = Arg(default=100, help="break speed multiplier of Minecraft environments")
    mine_sticky_attack: int = Arg(default=30, help="sticky value for the attack action")
    mine_sticky_jump: int = Arg(default=10, help="sticky value for the jump action")
    diambra_action_space: str = Arg(default="discrete", help="diambra action space: discrete|multi_discrete")
    diambra_attack_but_combination: bool = Arg(default=True, help="enable diambra attack button combos")
    diambra_noop_max: int = Arg(default=0, help="max noop actions after diambra reset")
    diambra_actions_stack: int = Arg(default=1, help="number of actions stacked in diambra observations")
