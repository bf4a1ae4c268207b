"""Environment construction (the port of sheeprl_tpu/utils/env.py's
`make_dict_env`, dummy backend only). The reference resizes and converts
images with cv2, which the port does without: an image that needs a resize
or a grayscale conversion raises instead."""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..envs import spaces

__all__ = ["make_dict_env", "get_dummy_env"]


def get_dummy_env(env_id: str):
    from ..envs.dummy import ContinuousDummyEnv, DiscreteDummyEnv, MultiDiscreteDummyEnv

    lid = env_id.lower()
    if "continuous" in lid:
        return ContinuousDummyEnv()
    if "multidiscrete" in lid:
        return MultiDiscreteDummyEnv()
    if "discrete" in lid:
        return DiscreteDummyEnv()
    raise ValueError(f"unrecognized dummy environment: {env_id}")


class DictObservation:
    """Expose a Box-observation env as a one-key dict-observation env."""

    def __init__(self, env, key: str):
        self.env = env
        self.key = key
        self.observation_space = spaces.Dict({key: env.observation_space})
        self.action_space = env.action_space

    def reset(self, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return {self.key: obs}, info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return {self.key: obs}, reward, terminated, truncated, info

    def close(self):
        self.env.close()


def make_dict_env(
    env_id: str,
    seed: int,
    rank: int,
    args: Any,
    run_name: Optional[str] = None,
    prefix: str = "",
    vector_env_idx: int = 0,
) -> Callable[[], DictObservation]:
    """Dict-observation env thunk for `*_dummy` env ids. A Box image
    observation is exposed under the first cnn key (default `rgb`), a Box
    vector observation under the first mlp key (default `state`)."""
    del seed, rank, run_name, prefix, vector_env_idx

    def thunk() -> DictObservation:
        lid = env_id.lower()
        if "dummy" not in lid:
            raise ValueError(
                f"env {env_id!r}: only the *_dummy backend is ported; the other "
                "backends need gymnasium"
            )
        env = get_dummy_env(lid)
        cnn_keys = list(getattr(args, "cnn_keys", None) or [])
        mlp_keys = list(getattr(args, "mlp_keys", None) or [])
        shape = env.observation_space.shape
        if len(shape) < 2:  # vector obs
            key = mlp_keys[0] if mlp_keys else "state"
            if not mlp_keys:
                args.mlp_keys = [key]
            return DictObservation(env, key)
        key = cnn_keys[0] if cnn_keys else "rgb"
        if not cnn_keys:
            args.cnn_keys = [key]
        screen = getattr(args, "screen_size", 64)
        channels = 1 if getattr(args, "grayscale_obs", False) else 3
        if shape != (screen, screen, channels):
            raise ValueError(
                f"{env_id} emits {shape} images but --screen_size {screen} / "
                f"grayscale_obs ask for {(screen, screen, channels)}; image "
                "resizing and grayscale conversion are not ported"
            )
        if getattr(args, "frame_stack", -1) > 0:
            raise ValueError("frame stacking is not ported")
        return DictObservation(env, key)

    return thunk
