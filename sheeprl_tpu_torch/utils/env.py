"""Environment construction (the port of sheeprl_tpu/utils/env.py's
`make_env` and `make_dict_env`): the `*_dummy` envs, CartPole-v1 through the
port's own copy of the reference's JAX CartPole (`envs/cartpole.py`) and
Pendulum-v1 through its JAX Pendulum (`envs/pendulum.py`), as the
reference routes an env it has only in JAX through its host twin (its
`pixeltoy` branch); the reference reaches these two through gymnasium.
`pixeltoy` takes that branch here too: its device env stepped at N = 1 on
the CPU (`envs/device/host.py:HostTwin`).
The reference resizes and converts images with cv2, which the port does
without: an image that needs a resize or a grayscale conversion raises
instead."""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..envs import spaces

__all__ = ["make_env", "make_dict_env", "get_dummy_env", "obs_zeros"]


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


def make_env(env_id: str, seed: Optional[int]) -> Callable[[], Any]:
    """Env thunk for the vector-observation algorithms (SAC): a flat Box
    observation. Only `Pendulum-v1` is ported (`envs/pendulum.py`, seeded
    by `seed`); the reference's video capture, velocity masking and action
    repeat are not."""

    def thunk():
        if env_id.lower() != "pendulum-v1":
            raise ValueError(
                f"env {env_id!r}: only Pendulum-v1 is ported for the vector-observation "
                "algorithms; the other backends need gymnasium"
            )
        from ..envs.pendulum import Pendulum

        return Pendulum(0 if seed is None else seed)

    return thunk


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
    """Dict-observation env thunk for `*_dummy` env ids, `CartPole-v1`
    (`envs/cartpole.py`), `Pendulum-v1` (`envs/pendulum.py`) and `pixeltoy`
    (`envs/device/host.py`, its frames under `rgb`), each seeded by `seed`. A Box image observation is exposed under the first
    cnn key (default `rgb`), a Box vector observation, CartPole's and
    Pendulum's included, under the first mlp key (default `state`)."""
    del rank, run_name, prefix, vector_env_idx

    def thunk() -> DictObservation:
        lid = env_id.lower()
        if "pixeltoy" in lid:
            # an env only the device has: its host twin steps the same
            # dynamics one env at a time (evaluation, --env_backend host)
            from ..envs.device import HostTwin, make_device_env

            twin = HostTwin(make_device_env(lid), seed=seed)
            _check_image(twin.observation_space.spaces["rgb"].shape, env_id, args)
            if not (getattr(args, "cnn_keys", None) or getattr(args, "mlp_keys", None)):
                args.cnn_keys = ["rgb"]
            return twin
        if lid == "cartpole-v1":
            from ..envs.cartpole import CartPole

            env = CartPole(seed)
        elif lid == "pendulum-v1":
            from ..envs.pendulum import Pendulum

            env = Pendulum(seed)
        elif "dummy" in lid:
            env = get_dummy_env(lid)
        else:
            raise ValueError(
                f"env {env_id!r}: only CartPole-v1, Pendulum-v1, pixeltoy and the *_dummy backend are ported; the "
                "other backends need gymnasium"
            )
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
        _check_image(shape, env_id, args)
        return DictObservation(env, key)

    return thunk


def _check_image(shape: tuple, env_id: str, args: Any) -> None:
    """Raise unless the env's images are what the config asks for: the port
    neither resizes, converts to grayscale nor stacks frames."""
    screen = getattr(args, "screen_size", 64)
    channels = 1 if getattr(args, "grayscale_obs", False) else 3
    if tuple(shape) != (screen, screen, channels):
        raise ValueError(
            f"{env_id} emits {tuple(shape)} images but --screen_size {screen} / "
            f"grayscale_obs ask for {(screen, screen, channels)}; image "
            "resizing and grayscale conversion are not ported"
        )
    if getattr(args, "frame_stack", -1) > 0:
        raise ValueError("frame stacking is not ported")


def obs_zeros(obs_space: dict, keys, lead: tuple, device) -> dict:
    """Zero observations `[*lead, *shape]` of each key's space, in its
    dtype, on `device`: the example arguments of a graphed step."""
    import numpy as np
    import torch

    return {k: torch.zeros(tuple(lead) + tuple(obs_space[k].shape), device=device,
                           dtype=torch.from_numpy(np.zeros(0, obs_space[k].dtype)).dtype) for k in keys}
