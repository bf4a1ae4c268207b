"""Batched environments on the device and the Anakin collectors (the port of
sheeprl_tpu/envs/jax/).

The reference's pure-JAX envs become batched torch envs on the run's
device: `core.py` (the env API, `VecDeviceEnv` with same-step auto-reset),
`cartpole.py`, `pendulum.py`, `pixeltoy.py`, `host.py` (one env on the CPU
for evaluation and `--env_backend host`) and `rollout.py` (the PPO and
DreamerV3 collectors, each one CUDA graph a rollout or chunk). The
package is named for what its envs are: it holds no JAX. `--env_backend
jax` keeps the reference's value, so a reference config carries across;
in the port it means these envs on the run's device.

    python -m sheeprl_tpu_torch ppo        --env_id CartPole-v1 --env_backend jax [--num_envs 1024]
    python -m sheeprl_tpu_torch dreamer_v3 --env_id pixeltoy    --env_backend jax --num_envs 16
"""

from __future__ import annotations

from .cartpole import CartPoleState, DeviceCartPole
from .core import DeviceEnv, VecDeviceEnv, VecEnvState, tree_select
from .host import HostTwin
from .pendulum import DevicePendulum, PendulumState
from .pixeltoy import DevicePixelToy, PixelToyState

__all__ = [
    "CartPoleState", "DeviceCartPole", "DeviceEnv", "DevicePendulum", "DevicePixelToy", "HostTwin", "PendulumState",
    "PixelToyState", "VecDeviceEnv", "VecEnvState", "has_device_env", "make_device_env", "tree_select",
]

# the env ids the host pipeline knows map to their device twins, plus the
# device-only pixel toy (the reference's registry, envs/jax/__init__.py:43)
_REGISTRY = {
    "cartpole-v1": DeviceCartPole,
    "pendulum-v1": DevicePendulum,
    "pixeltoy": DevicePixelToy,
    "pixeltoy-v0": DevicePixelToy,
}


def has_device_env(env_id: str) -> bool:
    """True when `env_id` has a batched device env (`--env_backend jax`
    is available for it)."""
    return env_id.lower() in _REGISTRY


def make_device_env(env_id: str, **overrides) -> DeviceEnv:
    """The device env registered under `env_id` (case-insensitive);
    `overrides` set its config (`max_episode_steps`, ...). Raises with the
    reference's message for an id that has none."""
    cls = _REGISTRY.get(env_id.lower())
    if cls is None:
        raise ValueError(
            f"no pure-JAX environment registered for {env_id!r}; available: "
            f"{sorted(_REGISTRY)} (use --env_backend host for everything else)"
        )
    return cls(**overrides)
