"""Replay storage (the port of sheeprl_tpu/data/buffers.py's `ReplayBuffer`,
PPO's rollout store, of the sequential sampling of its
`AsyncReplayBuffer`, which the Dreamer mains use, and of its
`EpisodeBuffer`, DreamerV2's `--buffer_type episode`).

`ReplayBuffer` is one ring `[buffer_size, n_envs, *item]` a key, on a torch
device (the default: a policy step's outputs go in without a round trip)
or in host numpy, with uniform sampling.

`AsyncReplayBuffer` keeps per-env rings, `add(data, indices)` so envs that reset
mid-step can append their reset rows alone, and `sample` of contiguous
windows `[n_samples, T, B, *item]`, each from one env. Its rings are host
numpy (`storage="host"`, the default; with `memmap_dir`, `.npy` files
there opened with `np.lib.format.open_memmap`, one a key, as the
reference's `--memmap_buffer` keeps them) or torch tensors on a device
(`storage="device"`), where a collector's rows go in without leaving the
device: `reserve(data_len)` picks the rows of a full-width write and
`add_direct(traj, idx, data_len)` scatters a `[data_len, n_envs, ...]`
trajectory there (the reference's `data/buffers.py:1341-1400`). Both
storages draw the same windows from the same generator; the device one
gathers them on the device and returns tensors.

Draws come from a `torch.Generator`; the sampled (env, start) pairs can be
injected instead, so a test can replay the reference's own sample.

`save` / `load` keep the reference's `.npz` layouts, so a buffer sidecar
the reference wrote loads here with the same rows: `ReplayBuffer`'s
(`pos`, `full`, `buffer_size`, `n_envs`, `buf_{key}` of shape
[buffer_size, n_envs, *item]) and `AsyncReplayBuffer`'s (`n_envs`,
`buffer_size`, and per env `b{i}_pos`, `b{i}_full`, `b{i}_buf_{key}` of
shape [buffer_size, 1, *item]). The sampler's state is the port's
generator's, under `torch_sampler_state`; the reference's `sampler_state`
(its JAX key) is not read, because the two draw different numbers anyway.
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from typing import Mapping, Sequence

import numpy as np
import torch

__all__ = ["AsyncReplayBuffer", "EpisodeBuffer", "ReplayBuffer"]

SAMPLER_KEY = "torch_sampler_state"


def _ring(storage: str, device: torch.device, memmap_dir: str | None, key: str, shape: tuple, dtype):
    """One key's zeroed storage: a tensor on `device`, a numpy array, or a
    memory-mapped `<memmap_dir>/<key>.npy`."""
    if storage == "device":
        return torch.zeros(shape, dtype=dtype, device=device)
    if memmap_dir is not None:
        return np.lib.format.open_memmap(os.path.join(memmap_dir, f"{key}.npy"), mode="w+", dtype=dtype, shape=shape)
    return np.zeros(shape, dtype=dtype)


class ReplayBuffer:
    """A circular buffer `[buffer_size, n_envs, *item]` a key, written at one
    head for all envs; uniform sampling. `storage="device"` keeps torch
    tensors on `device`, `storage="host"` numpy arrays (with `memmap_dir`,
    memory-mapped `<memmap_dir>/<key>.npy` files)."""

    def __init__(self, buffer_size: int, n_envs: int = 1, storage: str = "device",
                 device: torch.device | str = "cuda", obs_keys: Sequence[str] = ("observations",),
                 seed: int = 0, memmap_dir: str | None = None):
        if buffer_size <= 0:
            raise ValueError(f"buffer size must be > 0, got {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"n_envs must be > 0, got {n_envs}")
        if storage not in ("device", "host"):
            raise ValueError(f"storage must be 'device' or 'host', got {storage!r}")
        if memmap_dir is not None and storage != "host":
            raise ValueError("memmap_dir needs host storage")
        self.buffer_size = buffer_size
        self.n_envs = n_envs
        self.storage = storage
        self.device = torch.device(device)
        self.memmap_dir = memmap_dir
        if memmap_dir is not None:
            os.makedirs(memmap_dir, exist_ok=True)
        self.obs_keys = tuple(obs_keys)
        self._buf: dict | None = None
        self.pos = 0
        self.full = False
        self._gen = torch.Generator().manual_seed(seed)

    @property
    def prefers_host_adds(self) -> bool:
        """True when `add` wants host numpy values (host storage)."""
        return self.storage != "device"

    def __len__(self) -> int:
        return self.buffer_size

    def __getitem__(self, key: str):
        if self._buf is None:
            raise RuntimeError("buffer not initialized; add data first")
        return self._buf[key]

    def _as_stored(self, v):
        if self.storage == "device":
            return torch.as_tensor(v, device=self.device)
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    def add(self, data: Mapping) -> None:
        """Append `[T, n_envs, *item]` rows (tensors or arrays) at the write
        head, wrapping around."""
        data = {k: self._as_stored(v) for k, v in data.items()}
        length, n_envs = next(iter(data.values())).shape[:2]
        if n_envs != self.n_envs:
            raise ValueError(f"expected n_envs={self.n_envs}, got {n_envs}")
        if length == 0:
            return
        if length > self.buffer_size:
            data = {k: v[-self.buffer_size:] for k, v in data.items()}
            length = self.buffer_size
        if self._buf is None:
            self._allocate(data)
        if length == 1:  # a rollout step: one row, written in place
            rows = self.pos
            data = {k: v[0] for k, v in data.items()}
        else:
            rows = (self.pos + np.arange(length)) % self.buffer_size
            if self.storage == "device":
                rows = torch.from_numpy(rows).to(self.device)
        for k, v in data.items():
            self._buf[k][rows] = v
        self.full = self.full or self.pos + length >= self.buffer_size
        self.pos = (self.pos + length) % self.buffer_size

    def _allocate(self, data: Mapping) -> None:
        self._buf = {k: _ring(self.storage, self.device, self.memmap_dir, k,
                              (self.buffer_size, self.n_envs, *v.shape[2:]), v.dtype) for k, v in data.items()}

    def _valid_ranges(self, exclude: int) -> tuple[int, int]:
        """The sampling domain (first, n_valid): a draw r < first maps to
        itself, the rest shift past the write head."""
        first = self.pos - exclude
        if self.full:
            second_end = self.buffer_size if first >= 0 else self.buffer_size + first
            first = max(first, 0)
            return first, first + second_end - self.pos
        return first, first

    def can_sample(self, sample_next_obs: bool = False) -> bool:
        """Whether `sample` has a row to draw (the loops gate their first
        updates on it)."""
        if self._buf is None or (not self.full and self.pos == 0):
            return False
        return self._valid_ranges(1 if sample_next_obs else 0)[1] > 0

    def sample(self, batch_size: int, sample_next_obs: bool = False) -> dict:
        """`batch_size` rows drawn uniformly over (time, env), the write head
        excluded; with `sample_next_obs`, `pos - 1` too, and `next_<key>`
        holds each obs key's following row. -> {key: [batch_size, *item]}."""
        if batch_size <= 0:
            raise ValueError("batch_size must be > 0")
        if self._buf is None or (not self.full and self.pos == 0):
            raise RuntimeError("no samples in buffer; call add() first")
        first, n_valid = self._valid_ranges(1 if sample_next_obs else 0)
        if n_valid <= 0:
            raise RuntimeError("not enough valid entries to sample; add more data first")
        r = torch.randint(0, n_valid, (batch_size,), generator=self._gen)
        idx = torch.where(r < first, r, r - first + self.pos)
        env = torch.randint(0, self.n_envs, (batch_size,), generator=self._gen)
        if self.storage == "host":
            idx, env = idx.numpy(), env.numpy()
        else:
            idx, env = idx.to(self.device), env.to(self.device)
        out = {k: v[idx, env] for k, v in self._buf.items()}
        if sample_next_obs:
            nxt = (idx + 1) % self.buffer_size
            for k in self.obs_keys:
                out[f"next_{k}"] = self._buf[k][nxt, env]
        return out

    def save(self, path: str) -> None:
        """Write the ring, its write head and fullness, and the sampler's
        generator state into one `.npz` at `path` (the reference's layout,
        `--checkpoint_buffer`)."""
        flat = {"pos": np.int64(self.pos), "full": np.bool_(self.full), "buffer_size": np.int64(self.buffer_size),
                "n_envs": np.int64(self.n_envs), SAMPLER_KEY: self._gen.get_state().numpy()}
        for k, v in (self._buf or {}).items():
            flat[f"buf_{k}"] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
        with open(path, "wb") as fh:  # a file object: np.savez appends no suffix
            np.savez(fh, **flat)

    def load(self, path: str) -> None:
        """Restore what `save` wrote, or the reference's buffer sidecar (its
        sampler state, a JAX key, is skipped: the generators differ)."""
        with np.load(path) as data:
            if int(data["n_envs"]) != self.n_envs or int(data["buffer_size"]) != self.buffer_size:
                raise ValueError(f"checkpointed buffer is [{int(data['buffer_size'])}, {int(data['n_envs'])}], "
                                 f"this one [{self.buffer_size}, {self.n_envs}]")
            bufs = {k[len("buf_"):]: data[k] for k in data.files if k.startswith("buf_")}
            self._buf = {k: self._as_stored(np.ascontiguousarray(v)) for k, v in bufs.items()} or None
            if self._buf and self.memmap_dir is not None:
                rings = self._buf
                self._allocate(rings)
                for k, v in rings.items():
                    self._buf[k][...] = v
            self.pos, self.full = int(data["pos"]), bool(data["full"])
            if SAMPLER_KEY in data.files:
                self._gen.set_state(torch.from_numpy(data[SAMPLER_KEY].copy()))



class AsyncReplayBuffer:
    """`n_envs` independent rings of `buffer_size` rows each, stored as one
    array `[buffer_size, n_envs, *item]` per key with a write head per env:
    numpy arrays with `storage="host"` (memory-mapped `<memmap_dir>/<key>.npy`
    files with `memmap_dir`), tensors on `device` with `storage="device"`."""

    def __init__(self, buffer_size: int, n_envs: int = 1, seed: int = 0, storage: str = "host",
                 device: torch.device | str = "cpu", memmap_dir: str | None = None):
        if buffer_size <= 0:
            raise ValueError(f"buffer size must be > 0, got {buffer_size}")
        if n_envs <= 0:
            raise ValueError(f"n_envs must be > 0, got {n_envs}")
        if storage not in ("device", "host"):
            raise ValueError(f"storage must be 'device' or 'host', got {storage!r}")
        if memmap_dir is not None and storage != "host":
            raise ValueError("memmap_dir needs host storage")
        self.buffer_size = buffer_size
        self.n_envs = n_envs
        self.storage = storage
        self.device = torch.device(device)
        self.memmap_dir = memmap_dir
        if memmap_dir is not None:
            os.makedirs(memmap_dir, exist_ok=True)
        self._buf: dict | None = None
        self._pos = np.zeros(n_envs, dtype=np.int64)
        self._full = np.zeros(n_envs, dtype=bool)
        self._gen = torch.Generator().manual_seed(seed)
        self._pending: tuple[np.ndarray, int] | None = None

    @property
    def prefers_host_adds(self) -> bool:
        """True when `add` wants host numpy values (host storage)."""
        return self.storage != "device"

    def _stored(self, v):
        if self.storage == "device":
            return torch.as_tensor(v, device=self.device)
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    def _allocate(self, data: Mapping) -> None:
        self._buf = {k: _ring(self.storage, self.device, self.memmap_dir, k,
                              (self.buffer_size, self.n_envs, *v.shape[2:]), v.dtype) for k, v in data.items()}

    def add(self, data: Mapping, indices: Sequence[int] | None = None) -> None:
        """Append `data` ([L, n_cols, *item] per key) to the rings of the
        envs in `indices` (all envs when None), one column each."""
        data = {k: self._stored(v) for k, v in data.items()}
        cols = np.arange(self.n_envs) if indices is None else np.asarray(list(indices), dtype=np.int64)
        length, width = next(iter(data.values())).shape[:2]
        if width != cols.size:
            raise ValueError(f"data has {width} env columns but {cols.size} indices given")
        if self._buf is None:
            self._allocate(data)
        if length > self.buffer_size:
            data = {k: v[-self.buffer_size:] for k, v in data.items()}
            length = self.buffer_size
        for col, env in enumerate(cols):
            rows = (self._pos[env] + np.arange(length)) % self.buffer_size
            if self.storage == "device":
                rows = torch.from_numpy(rows).to(self.device)
            for k, v in data.items():
                self._buf[k][rows, env] = v[:, col]
            if self._pos[env] + length >= self.buffer_size:
                self._full[env] = True
            self._pos[env] = (self._pos[env] + length) % self.buffer_size

    def reserve(self, data_len: int = 1) -> np.ndarray:
        """The rows of a full-width `add_direct` of `data_len` rows:
        `concat(starts, cols)` as int32. The heads advance only in
        `add_direct`, so rows that are never written stay outside the
        sampling windows, and a retried `reserve` picks the same rows. Device
        storage only."""
        if self.storage != "device":
            raise RuntimeError("reserve()/add_direct() require device storage")
        if not 0 < data_len <= self.buffer_size:
            raise ValueError(f"data_len must be in 1..{self.buffer_size}, got {data_len}")
        starts = self._pos.copy()
        self._pending = (starts, int(data_len))
        return np.concatenate([starts, np.arange(self.n_envs)]).astype(np.int32)

    def add_direct(self, data: Mapping[str, torch.Tensor], idx, data_len: int = 1) -> None:
        """Scatter `data` (`[data_len, n_envs, *item]` per key, already on the
        device) at the rows `idx` (from `reserve`: a numpy array or a device
        tensor) and commit the head advance `reserve` deferred. Device
        storage only."""
        if self.storage != "device":
            raise RuntimeError("reserve()/add_direct() require device storage")
        pending = self._pending
        if pending is not None and pending[1] != data_len:
            raise ValueError(f"add_direct data_len {data_len} != reserved {pending[1]}")
        if not 0 < data_len <= self.buffer_size:
            raise ValueError(f"data_len must be in 1..{self.buffer_size}, got {data_len}")
        if self._buf is None:
            self._allocate(data)
        idx = torch.as_tensor(idx, device=self.device).long()
        starts, cols = idx[: self.n_envs], idx[self.n_envs:]
        rows = (starts[None, :] + torch.arange(data_len, device=self.device)[:, None]) % self.buffer_size
        for k, v in data.items():
            self._buf[k][rows, cols[None, :]] = v
        if pending is not None:
            starts_np, length = pending
            self._full |= starts_np + length >= self.buffer_size
            self._pos = (starts_np + length) % self.buffer_size
            self._pending = None

    def _windows(self, exclude: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-env sampling domains (first, n_valid): a draw r < first maps
        to itself, the rest shift past the write head."""
        first = self._pos - exclude
        second_end = np.where(first >= 0, self.buffer_size, self.buffer_size + first)
        n_valid = np.where(self._full, np.maximum(first, 0) + second_end - self._pos, first)
        return np.maximum(first, 0), n_valid

    def _partition(self, batch_size: int) -> np.ndarray:
        """Per-env sample counts: `batch_size // n_envs` each, the remainder
        rotating from an env drawn at random."""
        base, rem = divmod(batch_size, self.n_envs)
        counts = np.full(self.n_envs, base, dtype=np.int64)
        if rem:
            start = int(torch.randint(0, self.n_envs, (1,), generator=self._gen))
            counts[(start + np.arange(rem)) % self.n_envs] += 1
        return counts

    def sample(self, batch_size: int, sequence_length: int = 1, n_samples: int = 1,
               indices: tuple[np.ndarray, np.ndarray] | None = None) -> dict[str, np.ndarray]:
        """`n_samples` batches of `batch_size` windows of `sequence_length`
        rows -> {key: [n_samples, sequence_length, batch_size, *item]}.
        `indices` = (env [n_samples*batch_size], start [n_samples*batch_size])
        replaces the draws. Device storage returns tensors on its device."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be > 0")
        if self._buf is None:
            raise RuntimeError("no samples in buffer; call add() first")
        if sequence_length > self.buffer_size:
            raise ValueError(f"too long sequence_length ({sequence_length})")
        if indices is None:
            first, n_valid = self._windows(sequence_length - 1)
            counts = self._partition(batch_size)
            bad = (counts > 0) & (n_valid <= 0)
            if bad.any():
                e = int(np.argmax(bad))
                raise ValueError(
                    f"too long sequence_length ({sequence_length}) for env {e} with "
                    f"pos={int(self._pos[e])}, full={bool(self._full[e])}"
                )
            env = np.tile(np.repeat(np.arange(self.n_envs), counts), n_samples)
            u = torch.rand(env.size, generator=self._gen, dtype=torch.float64).numpy()
            r = np.floor(u * n_valid[env]).astype(np.int64)
            start = np.where(r < first[env], r, r - first[env] + self._pos[env])
        else:
            env, start = (np.asarray(a, dtype=np.int64) for a in indices)
        idx = (start[:, None] + np.arange(sequence_length)[None, :]) % self.buffer_size
        if self.storage == "device":
            idx, env = torch.from_numpy(idx).to(self.device), torch.from_numpy(env).to(self.device)
        out = {}
        for k, v in self._buf.items():
            s = v[idx, env[:, None]]  # [BD, T, *item]
            s = s.reshape(n_samples, batch_size, sequence_length, *s.shape[2:])
            if self.storage == "device":
                out[k] = s.transpose(1, 2).contiguous()
            else:
                out[k] = np.ascontiguousarray(np.swapaxes(s, 1, 2))
        return out

    def save(self, path: str) -> None:
        """Write every env's ring, write head and fullness, and the
        sampler's generator state into one `.npz` at `path` (the same file
        from either storage, and either storage loads it)."""
        flat: dict[str, np.ndarray] = {"n_envs": np.int64(self.n_envs), "buffer_size": np.int64(self.buffer_size)}
        for i in range(self.n_envs):
            flat[f"b{i}_pos"] = np.int64(self._pos[i])
            flat[f"b{i}_full"] = np.bool_(self._full[i])
            for k, v in (self._buf or {}).items():
                ring = v[:, i:i + 1]
                flat[f"b{i}_buf_{k}"] = ring.cpu().numpy() if isinstance(ring, torch.Tensor) else ring
        flat[SAMPLER_KEY] = self._gen.get_state().numpy()
        with open(path, "wb") as fh:  # a file object: np.savez appends no suffix
            np.savez(fh, **flat)

    def load(self, path: str) -> None:
        """Restore what `save` wrote, or the reference's buffer sidecar (its
        sampler state is skipped: the generators differ)."""
        with np.load(path) as data:
            if int(data["n_envs"]) != self.n_envs:
                raise ValueError(f"checkpointed buffer has {int(data['n_envs'])} envs, this one {self.n_envs}")
            if int(data["buffer_size"]) != self.buffer_size:
                raise ValueError(
                    f"checkpointed buffer holds {int(data['buffer_size'])} rows an env, this one {self.buffer_size}"
                )
            prefix = "b0_buf_"
            keys = [k[len(prefix):] for k in data.files if k.startswith(prefix)]
            rings = {k: self._stored(np.ascontiguousarray(
                np.concatenate([data[f"b{i}_buf_{k}"] for i in range(self.n_envs)], axis=1))) for k in keys}
            self._buf = rings or None
            if rings and self.memmap_dir is not None:
                self._allocate(rings)
                for k, v in rings.items():
                    self._buf[k][...] = v
            self._pending = None
            self._pos = np.array([int(data[f"b{i}_pos"]) for i in range(self.n_envs)], dtype=np.int64)
            self._full = np.array([bool(data[f"b{i}_full"]) for i in range(self.n_envs)], dtype=bool)
            if SAMPLER_KEY in data.files:
                self._gen.set_state(torch.from_numpy(data[SAMPLER_KEY].copy()))


class EpisodeBuffer:
    """Whole episodes on the host (numpy arrays, or with `memmap_dir` one
    `episode_<uuid>/` directory of `.npy` memmaps an episode), at most
    `buffer_size` steps in all; `sample` draws fixed windows of
    `sequence_length` steps -> {key: [n_samples, sequence_length,
    batch_size, *item]}. An episode holds exactly one done, at its last
    step, and is at least `sequence_length` long. Adding past the capacity
    evicts the oldest episodes, and their memmap directories. Draws come
    from `np.random.default_rng(seed)` in the reference's order."""

    def __init__(self, buffer_size: int, sequence_length: int, memmap_dir: str | os.PathLike | None = None,
                 seed: int = 0):
        if buffer_size <= 0:
            raise ValueError(f"buffer size must be > 0, got {buffer_size}")
        if sequence_length <= 0:
            raise ValueError(f"sequence length must be > 0, got {sequence_length}")
        if buffer_size < sequence_length:
            raise ValueError(f"sequence length ({sequence_length}) must not exceed buffer size ({buffer_size})")
        self.buffer_size = buffer_size
        self.sequence_length = sequence_length
        self._buf: list[dict[str, np.ndarray]] = []
        self._episode_dirs: list[str | None] = []
        self._cum_lengths: list[int] = []
        self.memmap_dir = None if memmap_dir is None else os.fspath(memmap_dir)
        if self.memmap_dir is not None:
            os.makedirs(self.memmap_dir, exist_ok=True)
        self._rng = np.random.default_rng(seed)

    @property
    def prefers_host_adds(self) -> bool:
        return True

    @property
    def buffer(self) -> list[dict[str, np.ndarray]]:
        return self._buf

    @property
    def full(self) -> bool:
        return bool(self._buf) and self._cum_lengths[-1] + self.sequence_length > self.buffer_size

    def __len__(self) -> int:
        return self._cum_lengths[-1] if self._buf else 0

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        return self._buf[i]

    def add(self, episode: Mapping) -> None:
        """Append one episode ({key: [L, *item]})."""
        dones = np.asarray(episode["dones"]).reshape(-1)
        if int((dones != 0).sum()) != 1:
            raise RuntimeError(f"episode must contain exactly one done, got {int((dones != 0).sum())}")
        if dones[-1] == 0:
            raise RuntimeError("the last step of an episode must be done")
        ep_len = dones.shape[0]
        if ep_len < self.sequence_length:
            raise RuntimeError(f"episode too short: {ep_len} < sequence_length {self.sequence_length}")
        if ep_len > self.buffer_size:
            raise RuntimeError(f"episode too long: {ep_len} > buffer_size {self.buffer_size}")
        if self.full or len(self) + ep_len > self.buffer_size:
            cum = np.array(self._cum_lengths)
            keep_from = int(((len(self) - cum + ep_len) <= self.buffer_size).argmax()) + 1
            for d in self._episode_dirs[:keep_from]:
                if d is not None and os.path.exists(d):
                    shutil.rmtree(d)
            self._buf = self._buf[keep_from:]
            self._episode_dirs = self._episode_dirs[keep_from:]
            self._cum_lengths = (cum[keep_from:] - cum[keep_from - 1]).tolist()
        self._cum_lengths.append(len(self) + ep_len)
        ep_dir = None
        if self.memmap_dir is not None:
            ep_dir = os.path.join(self.memmap_dir, f"episode_{uuid.uuid4()}")
            os.makedirs(ep_dir, exist_ok=True)
            stored = {}
            for k, v in episode.items():
                v = np.asarray(v)
                mm = np.lib.format.open_memmap(os.path.join(ep_dir, f"{k}.npy"), mode="w+", dtype=v.dtype,
                                               shape=v.shape)
                mm[:] = v
                stored[k] = mm
        else:
            stored = {k: np.asarray(v) for k, v in episode.items()}
        self._buf.append(stored)
        self._episode_dirs.append(ep_dir)

    def sample(self, batch_size: int, n_samples: int = 1, prioritize_ends: bool = False) -> dict[str, np.ndarray]:
        """`n_samples` batches of `batch_size` windows: an episode drawn
        uniformly for each window, then its start uniformly in [0, L - T]
        (with `prioritize_ends`, in [0, L) clipped to L - T, so the last
        window takes the extra mass)."""
        if batch_size <= 0 or n_samples <= 0:
            raise ValueError("batch_size and n_samples must be > 0")
        if not self._buf:
            raise RuntimeError("no episodes in buffer; call add() first")
        T = self.sequence_length
        counts = np.bincount(self._rng.integers(0, len(self._buf), size=batch_size * n_samples),
                             minlength=len(self._buf))
        chunks: dict[str, list[np.ndarray]] = {k: [] for k in self._buf[0]}
        for i, n in enumerate(counts):
            if n == 0:
                continue
            ep = self._buf[i]
            ep_len = next(iter(ep.values())).shape[0]
            upper = ep_len - T + 1 + (T if prioritize_ends else 0)
            starts = np.minimum(self._rng.integers(0, upper, size=(int(n), 1)), ep_len - T)
            idx = starts + np.arange(T)[None, :]
            for k in chunks:
                chunks[k].append(np.asarray(ep[k])[idx])
        out = {}
        for k, parts in chunks.items():
            cat = np.concatenate(parts, axis=0)  # [n_samples * batch_size, T, *item]
            cat = cat.reshape(n_samples, batch_size, T, *cat.shape[2:])
            out[k] = np.ascontiguousarray(np.swapaxes(cat, 1, 2))
        return out

    def state_dict(self) -> dict:
        """The episodes (host copies), the shape and the sampler's state."""
        return {"episodes": [{k: np.array(v) for k, v in ep.items()} for ep in self._buf],
                "buffer_size": self.buffer_size, "sequence_length": self.sequence_length,
                "sampler_state": self._rng.bit_generator.state}

    def load_state_dict(self, state: Mapping) -> None:
        """Re-add `state`'s episodes in order (into memmaps when this buffer
        has a `memmap_dir`), then restore the sampler, so the re-adds cannot
        move its stream."""
        if state["buffer_size"] != self.buffer_size or state["sequence_length"] != self.sequence_length:
            raise ValueError("checkpointed episode buffer shape mismatch")
        for d in self._episode_dirs:
            if d is not None and os.path.exists(d):
                shutil.rmtree(d)
        self._buf, self._episode_dirs, self._cum_lengths = [], [], []
        for ep in state["episodes"]:
            self.add(ep)
        if state.get("sampler_state") is not None:
            self._rng.bit_generator.state = state["sampler_state"]

    def save(self, path: str) -> None:
        """One `.npz` in the reference's layout: `n_episodes`,
        `buffer_size`, `sequence_length`, `ep{i}_{key}` and the numpy
        sampler state as JSON bytes under `sampler_state`."""
        st = self.state_dict()
        flat: dict[str, np.ndarray] = {"n_episodes": np.int64(len(st["episodes"])),
                                       "buffer_size": np.int64(self.buffer_size),
                                       "sequence_length": np.int64(self.sequence_length)}
        for i, ep in enumerate(st["episodes"]):
            for k, v in ep.items():
                flat[f"ep{i}_{k}"] = v
        flat["sampler_state"] = np.frombuffer(json.dumps(st["sampler_state"]).encode(), dtype=np.uint8)
        with open(path, "wb") as fh:  # a file object: np.savez appends no suffix
            np.savez(fh, **flat)

    def load(self, path: str) -> None:
        """Restore what `save` (or the reference's `EpisodeBuffer.save`) wrote."""
        with np.load(path) as data:
            episodes: list[dict] = [{} for _ in range(int(data["n_episodes"]))]
            for name in data.files:
                if name.startswith("ep"):
                    idx, key = name[2:].split("_", 1)
                    episodes[int(idx)][key] = data[name]
            sampler = None
            if "sampler_state" in data.files:
                sampler = json.loads(bytes(np.asarray(data["sampler_state"], dtype=np.uint8)).decode())
            self.load_state_dict({"episodes": episodes, "buffer_size": int(data["buffer_size"]),
                                  "sequence_length": int(data["sequence_length"]), "sampler_state": sampler})
