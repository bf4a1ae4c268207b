"""The port's `EpisodeBuffer` against the reference's, and the sequential
windows of `AsyncReplayBuffer` (DreamerV2's two `--buffer_type`s).

`EpisodeBuffer` draws from `np.random.default_rng(seed)` in the
reference's order, so with the same seed and the same episodes every
sample is the reference's bit for bit: uniform and `prioritize_ends`
windows, after evictions, from memmap storage, and after a `.npz` round
trip in either direction (the sampler's state travels with it). The
checks of the reference's own tests (tests/test_data/test_buffers.py:
142-190) run on the port as well. `AsyncReplayBuffer` draws from a torch
generator, not the reference's JAX key, so its check takes the reference's
draws: the same rows, the same validity windows, and the same windows at
the starts the reference's own sample drew.
"""

from __future__ import annotations

import os

import numpy as np
import pytest


def make_episode(length: int, start: int = 0, pixels: bool = False) -> dict[str, np.ndarray]:
    ep = {
        "observations": (start + np.arange(length, dtype=np.float32))[:, None],
        "dones": np.zeros((length, 1), np.float32),
    }
    ep["dones"][-1] = 1.0
    if pixels:
        ep["rgb"] = np.random.default_rng(start).integers(0, 255, (length, 8, 8, 3), dtype=np.uint8)
    return ep


def _pair(size: int, seq: int, seed: int, memmap=None):
    from sheeprl_tpu.data.buffers import EpisodeBuffer as RefBuffer
    from sheeprl_tpu_torch.data.buffers import EpisodeBuffer

    ref_dir = port_dir = None
    if memmap is not None:
        ref_dir, port_dir = memmap / "ref", memmap / "port"
    return RefBuffer(size, sequence_length=seq, memmap_dir=ref_dir, seed=seed), \
        EpisodeBuffer(size, sequence_length=seq, memmap_dir=port_dir, seed=seed)


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("prioritize_ends", [False, True])
@pytest.mark.parametrize("storage", ["memory", "memmap"])
def test_samples_are_the_references_bit_for_bit(tmp_path, prioritize_ends, storage):
    """Episodes of mixed lengths (pixels too), evictions past the capacity,
    and several samples in a row, each drawn from the same stream."""
    ref, port = _pair(60, 4, seed=3, memmap=tmp_path if storage == "memmap" else None)
    lengths = [9, 4, 17, 6, 12, 20, 5, 11]
    for i, n in enumerate(lengths):
        ep = make_episode(n, start=100 * i, pixels=True)
        ref.add(ep)
        port.add(ep)
        assert len(port) == len(ref) and port.full == ref.full
        if i >= 2:
            for batch, n_samples in ((5, 1), (3, 4)):
                _same(port.sample(batch, n_samples=n_samples, prioritize_ends=prioritize_ends),
                      ref.sample(batch, n_samples=n_samples, prioritize_ends=prioritize_ends))
    assert len(port.buffer) == len(ref.buffer) < len(lengths)  # the oldest were evicted
    for a, b in zip(port.buffer, ref.buffer):
        _same({k: np.asarray(v) for k, v in a.items()}, {k: np.asarray(v) for k, v in b.items()})
    if storage == "memmap":  # one directory for each episode kept, the evicted ones removed
        assert sorted(len(os.listdir(tmp_path / d)) for d in ("ref", "port")) == [len(ref.buffer)] * 2


def test_the_references_own_checks():
    """tests/test_data/test_buffers.py:142-182 on the port."""
    from sheeprl_tpu_torch.data.buffers import EpisodeBuffer

    eb = EpisodeBuffer(16, sequence_length=4)
    bad = make_episode(6)
    bad["dones"][2] = 1.0
    no_end = make_episode(6)
    no_end["dones"][-1] = 0.0
    for episode in (bad, no_end, make_episode(2), make_episode(20)):
        with pytest.raises(RuntimeError):
            eb.add(episode)
    eb = EpisodeBuffer(12, sequence_length=3)
    for i in range(5):
        eb.add(make_episode(5, start=10 * i))
    assert len(eb) <= 12 and eb[0]["observations"][0, 0] >= 10.0
    eb = EpisodeBuffer(64, sequence_length=4)
    eb.add(make_episode(10))
    eb.add(make_episode(8, start=100))
    s = eb.sample(6, n_samples=2)
    assert s["observations"].shape == (2, 4, 6, 1)
    np.testing.assert_allclose(np.diff(s["observations"][..., 0], axis=1), 1.0)
    eb = EpisodeBuffer(64, sequence_length=4, seed=1)
    eb.add(make_episode(32))
    starts = eb.sample(256, prioritize_ends=True)["observations"][0, 0, :, 0]
    assert (starts == 28.0).mean() > 0.10


def test_memmap_eviction_removes_the_files(tmp_path):
    from sheeprl_tpu_torch.data.buffers import EpisodeBuffer

    eb = EpisodeBuffer(10, sequence_length=3, memmap_dir=tmp_path / "eb")
    for i in range(4):
        eb.add(make_episode(5, start=10 * i))
    dirs = sorted(os.listdir(tmp_path / "eb"))
    assert len(dirs) == 2  # capacity 10 holds two 5-step episodes
    assert all(sorted(os.listdir(tmp_path / "eb" / d)) == ["dones.npy", "observations.npy"] for d in dirs)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_npz_round_trip_continues_the_sample_stream(tmp_path, writer):
    """A buffer saved mid-stream by either package loads in the other (and
    in itself) with its episodes and its sampler: the next samples are the
    ones the saved buffer would have drawn."""
    ref, port = _pair(40, 3, seed=5)
    for i, n in enumerate([7, 5, 9, 12]):
        ref.add(make_episode(n, start=10 * i))
        port.add(make_episode(n, start=10 * i))
    _same(port.sample(4, n_samples=2), ref.sample(4, n_samples=2))
    path = str(tmp_path / "buffer.npz")
    (ref if writer == "reference" else port).save(path)
    ref2, port2 = _pair(40, 3, seed=99)
    ref2.load(path)
    port2.load(path)
    want = ref.sample(6, n_samples=3, prioritize_ends=True)
    _same(port.sample(6, n_samples=3, prioritize_ends=True), want)
    _same(port2.sample(6, n_samples=3, prioritize_ends=True), want)
    _same(ref2.sample(6, n_samples=3, prioritize_ends=True), want)


def test_state_dict_round_trip_and_shape_checks():
    from sheeprl_tpu_torch.data.buffers import EpisodeBuffer

    a = EpisodeBuffer(30, 3, seed=2)
    for i in range(4):
        a.add(make_episode(6 + i, start=10 * i))
    a.sample(2)
    b = EpisodeBuffer(30, 3, seed=0)
    b.load_state_dict(a.state_dict())
    _same(b.sample(5, n_samples=2), a.sample(5, n_samples=2))
    with pytest.raises(ValueError, match="shape mismatch"):
        EpisodeBuffer(31, 3).load_state_dict(a.state_dict())
    with pytest.raises(RuntimeError, match="no episodes"):
        EpisodeBuffer(30, 3).sample(1)


def test_async_replay_buffer_windows_are_the_references():
    """Sequential sampling (`--buffer_type sequential`): after the same
    adds (every env, then reset rows for some envs alone, past the ring's
    end), the validity windows agree, and the windows at the starts of the
    reference's own sample are its bit for bit."""
    import jax

    from sheeprl_tpu.data.buffers import AsyncReplayBuffer as RefBuffer
    from sheeprl_tpu_torch.data.buffers import AsyncReplayBuffer

    size, n_envs, seq, batch, n_samples = 12, 3, 4, 6, 2
    ref = RefBuffer(size, n_envs, storage="device", sequential=True, obs_keys=("rgb",), seed=4)
    port = AsyncReplayBuffer(size, n_envs, seed=4)
    rng = np.random.default_rng(0)
    for step in range(17):
        cols = list(range(n_envs)) if step % 5 else [0, 2]
        rows = {"rgb": rng.integers(0, 255, (1, len(cols), 4, 4, 3), dtype=np.uint8),
                "rewards": rng.normal(size=(1, len(cols), 1)).astype(np.float32),
                "is_first": np.full((1, len(cols), 1), float(step % 5 == 0), np.float32)}
        ref.add(rows, None if len(cols) == n_envs else cols)
        port.add(rows, None if len(cols) == n_envs else cols)
    for want, got in zip(ref._windows(seq - 1), port._windows(seq - 1)):
        np.testing.assert_array_equal(got, want)
    key = ref._key
    want = ref.sample(batch, sequence_length=seq, n_samples=n_samples)
    # the reference's draw (`_store_sample`): a start index a row inside its env's window
    first, n_valid = ref._windows(seq - 1)
    env = np.tile(np.repeat(np.arange(n_envs), batch // n_envs), n_samples)
    r = np.asarray(jax.random.randint(jax.random.split(key)[1], (env.size,), 0, np.maximum(n_valid[env], 1)))
    start = np.where(r < first[env], r, r - first[env] + port._pos[env])
    got = port.sample(batch, sequence_length=seq, n_samples=n_samples, indices=(env, start))
    _same(got, {k: np.asarray(v) for k, v in want.items()})
