"""SAC's evaluation episode (the port of sheeprl_tpu/algos/sac/utils.py),
also DroQ's."""

from __future__ import annotations

import numpy as np
import torch

from .agent import SACActor

__all__ = ["test"]


def test(actor: SACActor, env, logger, args) -> float:
    """One greedy (mean-action) episode in `env` (closed at the end), reset
    with `args.seed`; logs `Test/cumulative_reward`. -> the episode's
    return."""
    device = actor.action_scale.device
    obs, _ = env.reset(seed=args.seed)
    done, cumulative_reward = False, 0.0
    while not done:
        with torch.no_grad():
            action = actor.get_greedy_actions(torch.as_tensor(np.asarray(obs, np.float32)[None], device=device))
        obs, reward, terminated, truncated, _ = env.step(action[0].cpu().numpy())
        done = terminated or truncated
        cumulative_reward += float(reward)
    logger.log("Test/cumulative_reward", cumulative_reward, 0)
    env.close()
    return cumulative_reward
