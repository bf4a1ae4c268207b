"""The two helpers of sheeprl_tpu/algos/ppo/ppo.py that the serving tier
uses: observation-key validation and the action-space width."""

from __future__ import annotations

import numpy as np

from ...envs import spaces


def validate_obs_keys(observation_space: spaces.Dict, args) -> tuple[list, list]:
    """cnn/mlp key validation: with neither given, every 3-D key is a cnn
    key and every 1-D key an mlp key; unknown keys are dropped, and no key
    left at all raises."""
    if args.cnn_keys is None and args.mlp_keys is None:
        args.cnn_keys = [k for k, s in observation_space.spaces.items() if len(s.shape) == 3]
        args.mlp_keys = [k for k, s in observation_space.spaces.items() if len(s.shape) == 1]
    cnn_keys = [k for k in (args.cnn_keys or []) if k in observation_space.spaces]
    mlp_keys = [k for k in (args.mlp_keys or []) if k in observation_space.spaces]
    if not cnn_keys and not mlp_keys:
        raise RuntimeError(
            f"no valid observation keys among cnn={args.cnn_keys} mlp={args.mlp_keys}; "
            f"env provides {sorted(observation_space.spaces)}"
        )
    args.cnn_keys, args.mlp_keys = cnn_keys, mlp_keys
    return cnn_keys, mlp_keys


def actions_dim_of(action_space) -> tuple[list[int], bool]:
    if isinstance(action_space, spaces.Box):
        return [int(np.prod(action_space.shape))], True
    if isinstance(action_space, spaces.Discrete):
        return [int(action_space.n)], False
    if isinstance(action_space, spaces.MultiDiscrete):
        return [int(n) for n in action_space.nvec], False
    raise ValueError(f"unsupported action space {type(action_space)}")
