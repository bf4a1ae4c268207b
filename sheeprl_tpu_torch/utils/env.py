"""Environment construction (the port of sheeprl_tpu/utils/env.py): `make_env`
for the vector-observation algorithms and `make_dict_env`, the
dict-observation chain, in the reference's wrapper order:

    base env -> step latency -> velocity mask -> ActionRepeat
      -> one-key dict observation -> image transform -> FrameStack
      -> TimeLimit(max_episode_steps // action_repeat) -> RecordEpisodeStatistics

The base envs are the `*_dummy` envs, CartPole-v1 through the port's own
copy of the reference's JAX CartPole (`envs/cartpole.py`), Pendulum-v1
through its JAX Pendulum (`envs/pendulum.py`), as the reference routes an
env it has only in JAX through its host twin (its `pixeltoy` branch), and
`pixeltoy` itself: its device env stepped at N = 1 on the CPU
(`envs/device/host.py:HostTwin`). The reference reaches CartPole and
Pendulum through gymnasium.

The image transform resizes with cv2's `INTER_AREA`, converts RGB to gray
with cv2's `COLOR_RGB2GRAY` and repeats a gray frame to RGB, all without
cv2: its fixed-point gray weights, its area averaging (and its rounding) on
a downscale, and its linear filter on an upscale are written here in numpy.

A thunk is a picklable callable, so `envs/vector.py:AsyncVectorEnv` can
send it to a worker process. The reference's video capture and
`RestartOnException` are not ported (the latter waits for the resilience
services, ROADMAP Queue A item 9).
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Any, Callable, Optional

import numpy as np

from ..envs import spaces
from ..envs.wrappers import (
    ActionRepeat,
    DictObservation,
    FrameStack,
    MaskVelocityWrapper,
    ObservationWrapper,
    RecordEpisodeStatistics,
    TimeLimit,
    maybe_step_latency,
)

__all__ = ["get_dummy_env", "make_dict_env", "make_env", "obs_zeros", "resize_area", "rgb_to_gray"]


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


def _base_env(env_id: str, seed: Optional[int]):
    lid = env_id.lower()
    if lid == "cartpole-v1":
        from ..envs.cartpole import CartPole

        return CartPole(0 if seed is None else seed)
    if lid == "pendulum-v1":
        from ..envs.pendulum import Pendulum

        return Pendulum(0 if seed is None else seed)
    if "dummy" in lid:
        return get_dummy_env(lid)
    if "pixeltoy" in lid:
        # an env only the device has: its host twin steps the same dynamics
        # one env at a time (evaluation, --env_backend host)
        from ..envs.device import HostTwin, make_device_env

        return HostTwin(make_device_env(lid), seed=0 if seed is None else seed)
    raise ValueError(
        f"env {env_id!r}: only CartPole-v1, Pendulum-v1, pixeltoy and the *_dummy backend are ported; "
        "the other backends need gymnasium"
    )


def _build_env(env_id: str, seed: Optional[int], mask_velocities: bool, action_repeat: int):
    env = maybe_step_latency(_base_env(env_id, seed))
    if mask_velocities:
        env = MaskVelocityWrapper(env, env_id)
    env = ActionRepeat(env, action_repeat)
    return RecordEpisodeStatistics(env)


def make_env(env_id: str, seed: Optional[int], idx: int = 0, capture_video: bool = False,
             run_name: Optional[str] = None, prefix: str = "", mask_velocities: bool = False,
             vector_env_idx: int = 0, action_repeat: int = 1) -> Callable[[], Any]:
    """Env thunk for the vector-observation algorithms (SAC, DroQ): a flat
    Box observation, the action repeated `action_repeat` times, episode
    statistics in the last step's info. `idx`, `capture_video`, `run_name`,
    `prefix` and `vector_env_idx` pick the env that records video in the
    reference; the port records none."""
    del idx, capture_video, run_name, prefix, vector_env_idx
    return functools.partial(_build_env, env_id, seed, mask_velocities, action_repeat)


# --- the image transform ---------------------------------------------------

# cv2's RGB -> gray weights for uint8, in 15-bit fixed point
_GRAY_R, _GRAY_G, _GRAY_B, _GRAY_SHIFT = 9798, 19235, 3735, 15
# cv2's linear resize coefficients for uint8: 11-bit fixed point a pass
_COEF_BITS = 11


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [H, W] uint8 gray, as cv2.COLOR_RGB2GRAY."""
    x = img.astype(np.int32)
    y = x[..., 0] * _GRAY_R + x[..., 1] * _GRAY_G + x[..., 2] * _GRAY_B
    return ((y + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT).astype(np.uint8)


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of cv2's area filter on a downscale: each output
    cell averages the input cells it covers, partial cells by the share
    covered (cv2's `computeResizeAreaTab`)."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_in - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = (sx1 - fsx1) / cell
        w[dx, sx1:sx2] = 1.0 / cell
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
    return w.astype(np.float32)


def _linear_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2's INTER_AREA on an upscale: a linear filter whose weights follow
    the covered share of each output cell. -> (left index [n_out], fixed-
    point weights [n_out, 2])."""
    scale, inv = n_in / n_out, n_out / n_in
    idx = np.zeros(n_out, np.int64)
    wts = np.zeros((n_out, 2), np.int64)
    one = 1 << _COEF_BITS
    for dx in range(n_out):
        sx = math.floor(dx * scale)
        fx = float(np.float32((dx + 1) - (sx + 1) * inv))
        fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        if sx >= n_in - 1:
            sx, fx = n_in - 1, 0.0
        idx[dx] = sx
        w1 = int(round(fx * one))
        wts[dx] = (one - w1, w1)
    return idx, wts


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """[H, W, C] uint8 -> [height, width, C] uint8, as cv2.resize with
    `INTER_AREA`: on an integer downscale the block mean (a 2 x 2 block
    rounds half up, a larger one to the nearest even, as cv2's fast area
    paths do), on any other downscale the weighted area mean, on an upscale
    cv2's area-weighted linear filter in 11-bit fixed point."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img.copy()
    x = img.astype(np.int64)
    if height <= h and width <= w:
        if h % height == 0 and w % width == 0:
            ky, kx = h // height, w // width
            s = x.reshape(height, ky, width, kx, -1).sum(axis=(1, 3))
            if ky == kx == 2:
                return ((s + 2) >> 2).astype(np.uint8)
            mean = s.astype(np.float32) * np.float32(1.0 / (ky * kx))
            return np.clip(np.rint(mean), 0, 255).astype(np.uint8)
        wy, wx = _area_weights(h, height), _area_weights(w, width)
        out = np.einsum("yh,hwc->ywc", wy, img.astype(np.float32))
        out = np.einsum("xw,ywc->yxc", wx, out)
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    iy, wy = _linear_taps(h, height)
    ix, wx = _linear_taps(w, width)
    ix1, iy1 = np.minimum(ix + 1, w - 1), np.minimum(iy + 1, h - 1)
    rows = x[:, ix] * wx[None, :, 0, None] + x[:, ix1] * wx[None, :, 1, None]  # [h, width, C]
    out = rows[iy] * wy[:, 0, None, None] + rows[iy1] * wy[:, 1, None, None]
    shift = 2 * _COEF_BITS
    return np.clip((out + (1 << (shift - 1))) >> shift, 0, 255).astype(np.uint8)


class _ImageTransform(ObservationWrapper):
    """Resize and gray or RGB the image keys, always emitting `[H, W, C]`
    uint8 (a channel-first `[C, H, W]` input is transposed first)."""

    def __init__(self, env, cnn_keys, screen_size: int, grayscale: bool):
        super().__init__(env)
        self._cnn_keys = tuple(cnn_keys)
        self._screen = screen_size
        self._gray = grayscale
        out = dict(env.observation_space.spaces)
        for k in self._cnn_keys:
            out[k] = spaces.Box(0, 255, (screen_size, screen_size, 1 if grayscale else 3), np.uint8)
        self.observation_space = spaces.Dict(out)

    def observation(self, obs):
        obs = dict(obs)
        for k in self._cnn_keys:
            img = np.asarray(obs[k])
            if img.ndim == 2:
                img = img[..., None]
            if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
                img = img.transpose(1, 2, 0)
            img = resize_area(img.astype(np.uint8), self._screen, self._screen)
            if self._gray and img.shape[-1] == 3:
                img = rgb_to_gray(img)[..., None]
            elif not self._gray and img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            obs[k] = img.astype(np.uint8)
        return obs


def _build_dict_env(env_id: str, seed: int, args: Any, mask_velocities: bool):
    cnn_keys = list(getattr(args, "cnn_keys", None) or [])
    mlp_keys = list(getattr(args, "mlp_keys", None) or [])
    grayscale = bool(getattr(args, "grayscale_obs", False))
    screen_size = getattr(args, "screen_size", 64)
    action_repeat = getattr(args, "action_repeat", 1)

    env = maybe_step_latency(_base_env(env_id, seed))
    if mask_velocities:
        env = MaskVelocityWrapper(env, env_id)
    env = ActionRepeat(env, action_repeat)

    if isinstance(env.observation_space, spaces.Box):
        if len(env.observation_space.shape) < 2:  # vector obs
            if cnn_keys:
                warnings.warn(f"{env_id} emits a vector observation; cnn_keys {cnn_keys} cannot be rendered "
                              "from it: exposing it as an mlp key")
            key = mlp_keys[0] if mlp_keys else "state"
            if not mlp_keys:
                args.mlp_keys = [key]
        else:  # image obs
            key = cnn_keys[0] if cnn_keys else "rgb"
            if not cnn_keys:
                args.cnn_keys = cnn_keys = [key]
        env = DictObservation(env, key)

    env_cnn_keys = {k for k, sp in env.observation_space.spaces.items() if len(sp.shape) in (2, 3)}
    active_cnn_keys = sorted(env_cnn_keys.intersection(cnn_keys))
    if active_cnn_keys:
        env = _ImageTransform(env, active_cnn_keys, screen_size, grayscale)
        frame_stack = getattr(args, "frame_stack", -1)
        if frame_stack > 0:
            dilation = getattr(args, "frame_stack_dilation", 1)
            if dilation <= 0:
                raise ValueError(f"frame_stack_dilation must be > 0, got {dilation}")
            env = FrameStack(env, frame_stack, active_cnn_keys, dilation)
    max_episode_steps = getattr(args, "max_episode_steps", -1)
    if max_episode_steps > 0:
        env = TimeLimit(env, max_episode_steps=max_episode_steps // action_repeat)
    return RecordEpisodeStatistics(env)


def make_dict_env(env_id: str, seed: int, rank: int, args: Any, run_name: Optional[str] = None,
                  prefix: str = "", mask_velocities: bool = False,
                  vector_env_idx: int = 0) -> Callable[[], Any]:
    """Dict-observation env thunk, seeded by `seed`: `args` carries the
    observation config (`cnn_keys`, `mlp_keys`, `grayscale_obs`,
    `screen_size`, `frame_stack`, `frame_stack_dilation`) and
    `action_repeat` and `max_episode_steps`. A Box image observation is
    exposed under the first cnn key (default `rgb`), a Box vector
    observation under the first mlp key (default `state`). `rank`,
    `run_name`, `prefix` and `vector_env_idx` pick the env that records
    video in the reference; the port records none."""
    del rank, run_name, prefix, vector_env_idx
    return functools.partial(_build_dict_env, env_id, seed, args, mask_velocities)


def obs_zeros(obs_space: dict, keys, lead: tuple, device) -> dict:
    """Zero observations `[*lead, *shape]` of each key's space, in its
    dtype, on `device`: the example arguments of a graphed step."""
    import torch

    return {k: torch.zeros(tuple(lead) + tuple(obs_space[k].shape), device=device,
                           dtype=torch.from_numpy(np.zeros(0, obs_space[k].dtype)).dtype) for k in keys}
