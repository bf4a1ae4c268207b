"""DreamerV3 helpers (the port of sheeprl_tpu/algos/dreamer_v3/utils.py):
`make_device_preprocess` and `test`, the evaluation episode."""

from __future__ import annotations

import numpy as np
import torch

from ...envs import spaces
from ...utils.env import make_dict_env
from ..ppo.agent import one_hot_to_env_actions

__all__ = ["make_device_preprocess", "test"]


def make_device_preprocess(cnn_keys, offset: float = 0.0):
    """Observation normalization on the device: the host ships RAW obs
    (uint8 pixels — 4x less transfer than pre-normalized f32) and images
    become float32 in [-offset, 1 - offset] where the step runs (offset 0
    for DreamerV3, 0.5 for V1 and V2). Key-based, not dtype-based, like
    the reference."""
    cnn = frozenset(cnn_keys)

    def prep(o: dict) -> dict:
        return {
            k: (v.to(torch.float32) / 255.0 - offset if offset else v.to(torch.float32) / 255.0)
            if k in cnn else v.to(torch.float32)
            for k, v in o.items()
        }

    return prep


def test(player, logger, args, cnn_keys, sample_actions: bool = False, offset: float = 0.0) -> tuple[float, int]:
    """Play one episode in a fresh env reset with `args.seed`, from
    `player.init_states(1)`, and log `Test/cumulative_reward`. Actions are
    the actor's samples when `sample_actions` (the reference's final test
    passes True: `noisy_step` with uniform draws from a generator seeded by
    `args.seed` and an exploration amount of 0), else the greedy step
    (`step`: a discrete actor's mode, or a continuous actor's likeliest of
    `BEST_OF` samples, with the posterior's Gumbels and, for a continuous
    actor, a fresh [BEST_OF, 1, A] draw of uniforms each step from that
    generator, as the reference splits its key at every step). A
    `--dry_run` episode ends after one step. `offset` is the image
    normalization's (`make_device_preprocess`).
    -> (the episode's return, its player steps)."""
    env = make_dict_env(args.env_id, args.seed, rank=0, args=args, prefix="test")()
    device = player.device
    preprocess = make_device_preprocess(cnn_keys, offset)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    no_exploration = torch.zeros((), device=device)
    obs, _ = env.reset(seed=args.seed)
    with torch.inference_mode():
        state = player.init_states(1)
    done, cumulative_reward, steps = False, 0.0, 0
    while not done:
        with torch.inference_mode():
            dev_obs = preprocess({k: torch.as_tensor(np.asarray(v)[None], device=device) for k, v in obs.items()})
            if sample_actions:
                state, actions = player.noisy_step(state, dev_obs, player.draw_noise(1, generator, device),
                                                   no_exploration)
            else:
                state, actions = player.step(state, dev_obs, generator=generator)
        act = one_hot_to_env_actions(actions.float(), player.actions_dim, player.is_continuous)[0]
        if isinstance(env.action_space, spaces.Discrete):
            act = act.item()
        obs, reward, terminated, truncated, _ = env.step(act)
        done = terminated or truncated or args.dry_run
        cumulative_reward += float(reward)
        steps += 1
    logger.log("Test/cumulative_reward", cumulative_reward, 0)
    env.close()
    return cumulative_reward, steps
