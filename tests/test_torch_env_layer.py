"""The port's env layer (`envs/wrappers.py`, `envs/vector.py`,
`utils/env.py`) against the reference's, and the three repairs that came
with it.

- Wrappers: each wrapper of both packages over the same scripted base env
  and action sequence, step for step: observations, rewards, `terminated`,
  `truncated` and the episode statistics equal (the arithmetic is the same
  float64 sums and float32 frames).
- Vector envs: the port's sync and async runners against the reference's
  over seeded scripted envs: observations, rewards, dones, infos and
  `final_observation` equal at every step.
- Image transform: resize (cv2's `INTER_AREA`) and gray (cv2's
  `COLOR_RGB2GRAY`) without cv2 against cv2 over seeded random images at
  64->64, 64->32, 84->64, 64->48 and 64->96, RGB and gray input: bit for
  bit at an integer downscale (and no resize) and for the gray
  conversion, at most 1 uint8 level elsewhere. And the whole
  `make_dict_env` chain of both packages on `discrete_dummy` (the same
  frames in both) with grayscale, resize, dilated frame stacking, action
  repeat and time limit.
- Repairs: DreamerV3's env chain at `DreamerV3Args()` defaults (action
  repeat 4, time limit 108,000 // 4) against the reference's chain built
  around its JAX CartPole host twin, teacher-forced from the same states:
  observations at atol 1e-5 (the port's CartPole against the JAX one,
  `tests/test_torch_cartpole.py`), rewards, `terminated`/`truncated` and
  the episode statistics equal; the serve ladder's budget under
  SHEEPRL_TPU_PARTITION_MEM_MB; serve's telemetry kill switch.

Async runners here use 2 envs and a few steps (each worker is a spawned
process).
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

import gymnasium as gym
import numpy as np
import pytest

# ---------------------------------------------------------------------------
# a scripted env both packages can wrap
# ---------------------------------------------------------------------------

FRAME = (8, 8, 3)


class _Scripted:
    """A seeded env with an image and a vector key: the frames and the
    state come from a numpy generator seeded at each seeded reset; the
    reward is `action + t / 10`; an episode terminates after `3 + seed % 3`
    steps. `box=True` emits the vector alone (a Box observation)."""

    def __init__(self, seed: int = 0, box: bool = False):
        self._seed, self._box = seed, box
        self._rng = np.random.default_rng(seed)
        self._t = 0

    def _obs(self):
        state = self._rng.normal(size=4).astype(np.float32)
        if self._box:
            return state
        return {"rgb": self._rng.integers(0, 256, FRAME, dtype=np.uint8), "state": state}

    def _reset(self, seed=None):
        if seed is not None:
            self._seed = seed
            self._rng = np.random.default_rng(seed)
        self._t = 0
        return self._obs(), {}

    def _step(self, action):
        self._t += 1
        return self._obs(), float(action) + self._t / 10, self._t >= 3 + self._seed % 3, False, {}


def _port_spaces(box: bool):
    from sheeprl_tpu_torch.envs import spaces

    state = spaces.Box(-np.inf, np.inf, (4,), np.float32)
    obs = state if box else spaces.Dict({"rgb": spaces.Box(0, 255, FRAME, np.uint8), "state": state})
    return obs, spaces.Discrete(3)


class PortScripted(_Scripted):
    def __init__(self, seed: int = 0, box: bool = False):
        super().__init__(seed, box)
        self.observation_space, self.action_space = _port_spaces(box)

    def reset(self, seed=None, options=None):
        return self._reset(seed)

    def step(self, action):
        return self._step(action)

    def close(self):
        pass


class GymScripted(gym.Env, _Scripted):
    def __init__(self, seed: int = 0, box: bool = False):
        _Scripted.__init__(self, seed, box)
        state = gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)
        self.observation_space = state if box else gym.spaces.Dict(
            {"rgb": gym.spaces.Box(0, 255, FRAME, np.uint8), "state": state})
        self.action_space = gym.spaces.Discrete(3)
        self.spec = gym.envs.registration.EnvSpec(id="CartPole-v1", entry_point=None)

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        return self._reset(seed)

    def step(self, action):
        return self._step(action)


def _assert_same(a, b, where: str, atol: float = 0.0):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k}]", atol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (where, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=where)
    else:
        assert a == b, (where, a, b)


def _episode(info: dict):
    ep = info.get("episode")
    return None if ep is None else (float(ep["r"]), int(ep["l"]))


def _drive(port, ref, actions, seed: int, atol: float = 0.0):
    """Reset both with `seed`, step both through `actions` (each resets
    after its episode ends), and hold them equal."""
    _assert_same(port.reset(seed=seed)[0], ref.reset(seed=seed)[0], "reset", atol)
    for i, a in enumerate(actions):
        po, pr, pt, ptr, pinfo = port.step(a)
        ro, rr, rt, rtr, rinfo = ref.step(a)
        _assert_same(po, ro, f"obs {i}", atol)
        assert float(pr) == float(rr) and (bool(pt), bool(ptr)) == (bool(rt), bool(rtr)), i
        assert _episode(pinfo) == _episode(rinfo), i
        if pt or ptr:
            _assert_same(port.reset()[0], ref.reset()[0], f"reset {i}", atol)


ACTIONS = [0, 2, 1, 1, 0, 2, 2, 1, 0, 0, 1, 2, 0, 1, 2, 2, 0, 1]


def _wrapped(name: str, seed: int):
    from sheeprl_tpu.envs import wrappers as rw
    from sheeprl_tpu_torch.envs import wrappers as pw

    if name == "action_repeat":
        return pw.ActionRepeat(PortScripted(seed), 2), rw.ActionRepeat(GymScripted(seed), 2)
    if name == "mask_velocity":
        return (pw.MaskVelocityWrapper(PortScripted(seed, box=True), "CartPole-v1"),
                rw.MaskVelocityWrapper(GymScripted(seed, box=True)))
    if name == "frame_stack":
        return (pw.FrameStack(PortScripted(seed), 3, ["rgb"], dilation=2),
                rw.FrameStack(GymScripted(seed), 3, ["rgb"], dilation=2))
    if name == "dict_observation":
        return (pw.DictObservation(PortScripted(seed, box=True), "vec"),
                rw.DictObservation(GymScripted(seed, box=True), "vec"))
    if name == "time_limit":
        return pw.TimeLimit(PortScripted(seed), 2), gym.wrappers.TimeLimit(GymScripted(seed), 2)
    if name == "episode_statistics":
        return (pw.RecordEpisodeStatistics(pw.ActionRepeat(PortScripted(seed), 2)),
                gym.wrappers.RecordEpisodeStatistics(rw.ActionRepeat(GymScripted(seed), 2)))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["action_repeat", "mask_velocity", "frame_stack", "dict_observation", "time_limit",
                                  "episode_statistics"])
@pytest.mark.parametrize("seed", [0, 4])
def test_wrapper_matches_the_reference(name, seed):
    port, ref = _wrapped(name, seed)
    _drive(port, ref, ACTIONS, seed)
    if name == "frame_stack":
        assert port.observation_space.spaces["rgb"].shape == ref.observation_space["rgb"].shape == (8, 8, 9)
    if name == "dict_observation":
        assert list(port.observation_space.spaces) == list(ref.observation_space.spaces) == ["vec"]


@pytest.mark.parametrize("value", [None, "0", "x", "2.5"])
def test_step_latency_is_applied_as_the_reference_applies_it(value, monkeypatch):
    from sheeprl_tpu.envs import wrappers as rw
    from sheeprl_tpu_torch.envs import wrappers as pw

    if value is None:
        monkeypatch.delenv("SHEEPRL_TPU_ENV_LATENCY_MS", raising=False)
    else:
        monkeypatch.setenv("SHEEPRL_TPU_ENV_LATENCY_MS", value)
    port, ref = pw.maybe_step_latency(PortScripted()), rw.maybe_step_latency(GymScripted())
    assert isinstance(port, pw.StepLatencyWrapper) == isinstance(ref, rw.StepLatencyWrapper) == (value == "2.5")
    if value == "2.5":
        port.reset(seed=0)
        t0 = time.perf_counter()
        port.step(0)
        assert time.perf_counter() - t0 >= 0.0025


def test_wrappers_refuse_what_the_reference_refuses():
    from sheeprl_tpu_torch.envs import wrappers as pw

    with pytest.raises(ValueError, match="positive"):
        pw.ActionRepeat(PortScripted(), 0)
    with pytest.raises(NotImplementedError, match="velocity masking"):
        pw.MaskVelocityWrapper(PortScripted(box=True), "Acrobot-v1")
    with pytest.raises(RuntimeError, match="cnn key"):
        pw.FrameStack(PortScripted(), 2, ["depth"])
    with pytest.raises(RuntimeError, match="Dict"):
        pw.FrameStack(PortScripted(box=True), 2, ["rgb"])


# ---------------------------------------------------------------------------
# vector envs
# ---------------------------------------------------------------------------


def _port_thunk(seed: int):
    from sheeprl_tpu_torch.envs.wrappers import RecordEpisodeStatistics

    return RecordEpisodeStatistics(PortScripted(seed))


def _ref_thunk(seed: int):
    return gym.wrappers.RecordEpisodeStatistics(GymScripted(seed))


def _infos_equal(port_infos, ref_infos, where: str):
    assert len(port_infos) == len(ref_infos), where
    for i, (p, r) in enumerate(zip(port_infos, ref_infos)):
        assert ("final_observation" in p) == ("final_observation" in r), (where, i)
        if "final_observation" in p:
            _assert_same(p["final_observation"], r["final_observation"], f"{where} final {i}")
        assert _episode(p) == _episode(r), (where, i)


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "async"])
def test_vector_env_matches_the_reference(sync):
    from sheeprl_tpu.envs.vector import make_vector_env as ref_make
    from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv, SyncVectorEnv
    from sheeprl_tpu_torch.envs.vector import make_vector_env as port_make

    seeds = [3, 7]
    port = port_make([functools.partial(_port_thunk, s) for s in seeds], sync=sync)
    ref = ref_make([functools.partial(_ref_thunk, s) for s in seeds], sync=sync)
    try:
        assert isinstance(port, SyncVectorEnv if sync else AsyncVectorEnv) and port.num_envs == 2
        if not sync:
            assert len(port.processes) == 2 and all(p.is_alive() for p in port.processes)
        p_obs, p_infos = port.reset(seed=11)
        r_obs, r_infos = ref.reset(seed=11)
        _assert_same(p_obs, r_obs, "reset")
        rng = np.random.default_rng(0)
        finals = 0
        for t in range(10):
            actions = [int(a) for a in rng.integers(0, 3, 2)]
            p_obs, p_rew, p_term, p_trunc, p_infos = port.step(actions)
            r_obs, r_rew, r_term, r_trunc, r_infos = ref.step(actions)
            _assert_same(p_obs, r_obs, f"step {t}")
            for a, b in ((p_rew, r_rew), (p_term, r_term), (p_trunc, r_trunc)):
                _assert_same(a, b, f"step {t}")
            _infos_equal(p_infos, r_infos, f"step {t}")
            finals += sum("final_observation" in i for i in p_infos)
        assert finals >= 3  # episodes of 3 (seed 3) and 4 (seed 7) steps ended inside the window
    finally:
        port.close()
        ref.close()
    if not sync:
        assert not any(p.is_alive() for p in port.processes)


def _dies(seed: int):
    from sheeprl_tpu_torch.envs.wrappers import Wrapper

    class Dying(Wrapper):
        def step(self, action):
            if action == 2:
                os._exit(3)
            return self.env.step(action)

    return Dying(PortScripted(seed))


def _raises_in_step(seed: int):
    from sheeprl_tpu_torch.envs.wrappers import Wrapper

    class Raising(Wrapper):
        def step(self, action):
            raise KeyError("scripted failure")

    return Raising(PortScripted(seed))


def test_async_vector_env_raises_when_a_worker_dies_or_fails():
    from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv

    envs = AsyncVectorEnv([functools.partial(_dies, 0), functools.partial(_dies, 1)])
    try:
        envs.reset(seed=0)
        envs.step([0, 1])
        with pytest.raises(RuntimeError, match="worker 1 .* (died|closed)"):
            envs.step([0, 2])
    finally:
        envs.close()
    assert not any(p.is_alive() for p in envs.processes)
    envs = AsyncVectorEnv([functools.partial(_raises_in_step, 0)])
    try:
        envs.reset(seed=0)
        with pytest.raises(RuntimeError, match="KeyError: 'scripted failure'"):
            envs.step([0])
    finally:
        envs.close()
    assert not any(p.is_alive() for p in envs.processes)


# ---------------------------------------------------------------------------
# the image transform
# ---------------------------------------------------------------------------

SIZES = [(64, 64), (64, 32), (84, 64), (64, 48), (64, 96)]


@pytest.mark.parametrize("size_in,size_out", SIZES)
@pytest.mark.parametrize("channels", [3, 1])
def test_resize_matches_cv2(size_in, size_out, channels):
    import cv2

    from sheeprl_tpu_torch.utils.env import resize_area

    rng = np.random.default_rng(size_in * 1000 + size_out + channels)
    worst = 0
    for _ in range(4):
        img = rng.integers(0, 256, (size_in, size_in, channels), dtype=np.uint8)
        want = cv2.resize(img, (size_out, size_out), interpolation=cv2.INTER_AREA).reshape(size_out, size_out,
                                                                                            channels)
        got = resize_area(img, size_out, size_out)
        assert got.dtype == np.uint8 and got.shape == want.shape
        worst = max(worst, int(np.abs(got.astype(np.int64) - want).max()))
    exact = size_in % size_out == 0
    assert worst <= (0 if exact else 1), worst


def test_gray_matches_cv2_bit_for_bit():
    import cv2

    from sheeprl_tpu_torch.utils.env import rgb_to_gray

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (128, 96, 3), dtype=np.uint8)
    np.testing.assert_array_equal(rgb_to_gray(img), cv2.cvtColor(img, cv2.COLOR_RGB2GRAY))


@pytest.mark.parametrize("size_in,size_out", SIZES)
@pytest.mark.parametrize("gray_in,gray_out", [(False, False), (False, True), (True, False), (True, True)])
def test_image_transform_matches_the_reference(size_in, size_out, gray_in, gray_out):
    """`_ImageTransform` of both packages over the same frames, including
    a channel-first input: a resize and a conversion to gray or to RGB."""
    from sheeprl_tpu.utils.env import _ImageTransform as RefTransform
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.utils.env import _ImageTransform as PortTransform

    shape = (size_in, size_in, 1 if gray_in else 3)
    port_env = type("E", (), {"observation_space": spaces.Dict({"rgb": spaces.Box(0, 255, shape, np.uint8)}),
                              "action_space": spaces.Discrete(2)})()
    ref_env = gym.Env()
    ref_env.observation_space = gym.spaces.Dict({"rgb": gym.spaces.Box(0, 255, shape, np.uint8)})
    ref_env.action_space = gym.spaces.Discrete(2)
    port, ref = PortTransform(port_env, ["rgb"], size_out, gray_out), RefTransform(ref_env, ["rgb"], size_out,
                                                                                    gray_out)
    assert port.observation_space.spaces["rgb"].shape == ref.observation_space["rgb"].shape
    rng = np.random.default_rng(size_in + size_out)
    for channel_first in (False, True):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        if channel_first and not gray_in:
            img = np.ascontiguousarray(img.transpose(2, 0, 1))
        got, want = port.observation({"rgb": img})["rgb"], ref.observation({"rgb": img})["rgb"]
        assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
        exact = size_in % size_out == 0 or (gray_out and size_in == size_out)
        assert int(np.abs(got.astype(np.int64) - want).max()) <= (0 if exact else 1)


def _dummy_args(**kw):
    from sheeprl_tpu.algos.ppo.args import PPOArgs as RefArgs
    from sheeprl_tpu_torch.algos.ppo.args import PPOArgs as PortArgs

    common = dict(cnn_keys=["rgb"], mlp_keys=[], grayscale_obs=True, screen_size=32, frame_stack=3,
                  frame_stack_dilation=2, action_repeat=2, max_episode_steps=7)
    common.update(kw)
    return PortArgs(**common), RefArgs(**common)


@pytest.mark.parametrize("screen", [32, 48])
def test_dict_env_chain_matches_the_reference_on_dummy_pixels(screen):
    """`make_dict_env` of both packages on `discrete_dummy` (the same
    frames in both): gray, resized, 3 frames of dilation 2, each action
    repeated twice, a time limit of 7 // 2 steps."""
    from sheeprl_tpu.utils.env import make_dict_env as ref_make
    from sheeprl_tpu_torch.utils.env import make_dict_env as port_make

    port_args, ref_args = _dummy_args(screen_size=screen)
    port, ref = port_make("discrete_dummy", 0, 0, port_args)(), ref_make("discrete_dummy", 0, 0, ref_args)()
    assert port.observation_space.spaces["rgb"].shape == ref.observation_space["rgb"].shape == (screen, screen, 3)
    _drive(port, ref, [0, 1] * 9, seed=0, atol=0 if 64 % screen == 0 else 1)


# ---------------------------------------------------------------------------
# repairs
# ---------------------------------------------------------------------------


def test_dreamer_env_chain_at_default_args_matches_the_reference(monkeypatch):
    """`make_dict_env("CartPole-v1")` at `DreamerV3Args()` defaults in both
    packages (each action repeated 4 times, a time limit of 108,000 // 4),
    the reference's around its JAX CartPole host twin: teacher-forced from
    the same state at every player step (the port's state set to the
    reference's), the same observations (atol 1e-5), summed rewards, ends
    and episode statistics over scripted actions, a first episode
    truncated at the twin's 500 steps inside a repeat."""
    import jax.numpy as jnp

    import sheeprl_tpu.utils.env as ref_env_mod
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args as RefArgs
    from sheeprl_tpu.envs.jax import JaxEnvGymWrapper, make_jax_env
    from sheeprl_tpu.envs.jax.cartpole import CartPoleState
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args as PortArgs
    from sheeprl_tpu_torch.utils.env import make_dict_env as port_make

    monkeypatch.setattr(ref_env_mod.gym, "make", lambda env_id, **kw: JaxEnvGymWrapper(make_jax_env(env_id.lower())))
    port_args, ref_args = PortArgs(mlp_keys=["state"], cnn_keys=[]), RefArgs(mlp_keys=["state"], cnn_keys=[])
    assert port_args.action_repeat == ref_args.action_repeat == 4
    assert port_args.max_episode_steps == ref_args.max_episode_steps == 108000
    port = port_make("CartPole-v1", 5, 0, port_args)()
    ref = ref_env_mod.make_dict_env("CartPole-v1", 5, 0, ref_args)()
    port_inner, ref_inner = port.unwrapped, ref.unwrapped
    rng = np.random.default_rng(0)

    def restart(t0: int):
        start = rng.uniform(-0.05, 0.05, 4).astype(np.float32)
        port.reset(seed=5)
        ref.reset(seed=5)
        port_inner.state, port_inner.t = start.copy(), t0
        ref_inner._state = CartPoleState(state=jnp.asarray(start), t=jnp.asarray(t0, jnp.int32))

    restart(500 - 10)  # the first episode reaches the twin's truncation within 3 player steps
    ends = {"terminated": 0, "truncated": 0}
    for i in range(120):
        s = port_inner.state
        action = int(s[2] + 0.5 * s[3] > 0) if i < 3 else int(rng.integers(0, 2))
        po, pr, pt, ptr, pinfo = port.step(action)
        ro, rr, rt, rtr, rinfo = ref.step(action)
        np.testing.assert_allclose(po["state"], np.asarray(ro["state"]), rtol=0, atol=1e-5, err_msg=f"step {i}")
        assert pr == rr and (pt, ptr) == (bool(rt), bool(rtr)), i
        assert _episode(pinfo) == _episode(rinfo), i
        if pt or ptr:
            ends["terminated" if pt else "truncated"] += 1
            assert pinfo["episode"]["r"] > pinfo["episode"]["l"]  # 4 env steps a player step, reward 1 each
            restart(0)
        else:
            port_inner.state = np.asarray(ref_inner._state.state).copy()
    assert ends["truncated"] == 1 and ends["terminated"] >= 3, ends


@pytest.mark.parametrize("value", ["64", "x", None])
def test_serve_budget_follows_the_partition_budget(value, monkeypatch):
    from sheeprl_tpu.serve.ladder import serve_mem_budget_bytes as ref_budget
    from sheeprl_tpu_torch.serve.ladder import serve_mem_budget_bytes as port_budget

    monkeypatch.delenv("SHEEPRL_TPU_SERVE_MEM_MB", raising=False)
    if value is None:
        monkeypatch.delenv("SHEEPRL_TPU_PARTITION_MEM_MB", raising=False)
    else:
        monkeypatch.setenv("SHEEPRL_TPU_PARTITION_MEM_MB", value)
    assert port_budget() == ref_budget() == (64 if value == "64" else 512) * 2**20


@pytest.mark.timeout(120)
def test_serve_writes_no_telemetry_under_the_kill_switch(tmp_path, monkeypatch):
    """SHEEPRL_TPU_TELEMETRY=0: a CPU serve answers and writes no
    telemetry.jsonl, as the reference's `Telemetry.from_args` (the writer
    its serve builds) writes none."""
    from sheeprl_tpu.telemetry.core import Telemetry as RefTelemetry
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.serve.client import ServeClient

    monkeypatch.setenv("SHEEPRL_TPU_TELEMETRY", "0")
    ref = RefTelemetry.from_args(type("A", (), {})(), str(tmp_path / "ref"), role="serve")
    ref.event("serve.start")
    ref.close()
    assert not os.path.exists(tmp_path / "ref" / "telemetry.serve.jsonl")
    assert not os.path.exists(tmp_path / "ref" / "telemetry.jsonl")

    model = ("--env_id discrete_dummy --cnn_keys rgb --cnn_channels_multiplier 2 --dense_units 16 "
             "--recurrent_state_size 16 --hidden_size 16 --stochastic_size 4 --discrete_size 4")
    errors: list[BaseException] = []

    def _serve():
        try:
            run(["serve", "--device", "cpu", "--model_argv", model, "--root_dir", str(tmp_path), "--run_name", "r",
                 "--serve_requests", "2", "--deadline_ms", "0", "--ladder", "1"])
        except BaseException as err:  # surfaced below
            errors.append(err)

    server = threading.Thread(target=_serve, daemon=True)
    server.start()
    addr = tmp_path / "r" / "serve_address"
    deadline = time.monotonic() + 60
    while not addr.exists() and not errors and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not errors, errors
    with ServeClient(addr.read_text().strip()) as client:
        for _ in range(2):
            res, _ = client.request({"rgb": np.zeros((1, 64, 64, 3), np.uint8)})
            assert res["actions"].shape == (1, 2)
    server.join(timeout=60)
    assert not server.is_alive() and not errors, errors
    assert os.path.exists(tmp_path / "r" / "args.json")
    assert not os.path.exists(tmp_path / "r" / "telemetry.jsonl")


def test_telemetry_from_args_writes_its_start_and_interval(tmp_path, monkeypatch):
    """With telemetry on, `from_args` writes the `start` event, `interval`
    merges the phase times and the gauges and flags non-finite metrics,
    `close` writes `end`."""
    from sheeprl_tpu_torch.telemetry.core import Telemetry, active_telemetry

    monkeypatch.delenv("SHEEPRL_TPU_TELEMETRY", raising=False)
    telem = Telemetry.from_args(type("A", (), {"env_id": "x", "seed": 3})(), str(tmp_path), algo="ppo")
    assert telem in active_telemetry()
    telem.add_gauges(lambda: {"G/x": 1.0})
    telem.mark("rollout")
    time.sleep(0.01)
    telem.mark("train")
    first = telem.interval({"Loss/a": 1.0}, 10, 5.0)
    second = telem.interval({"Loss/a": float("nan")}, 20, 5.0)
    telem.close()
    assert telem not in active_telemetry()
    assert first["Time/rollout_seconds"] >= 0.01 and first["G/x"] == 1.0 and "Time/rollout_sps" not in first
    assert "Time/train_sps" in second and second["Health/nonfinite_metrics"] == 1.0
    with open(tmp_path / "telemetry.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    assert [r["event"] for r in records] == ["start", "interval", "health.nan", "interval", "end"]
    assert records[0]["algo"] == "ppo" and records[0]["seed"] == 3 and records[-2]["metrics"]["Loss/a"] == "nan"


def test_phase_timers_match_the_reference():
    """The same sequence of marks and nested phases on both packages'
    timers names the same phases."""
    from sheeprl_tpu.telemetry.phase import PhaseTimers as RefTimers
    from sheeprl_tpu_torch.telemetry.phase import PhaseTimers as PortTimers

    names = []
    for timers in (PortTimers(), RefTimers()):
        timers.mark("rollout")
        with timers.phase("train"):
            with timers.phase("dispatch"):
                pass
            flushed_open = timers.flush()
        timers.mark(None)
        names.append((sorted(flushed_open), sorted(timers.flush())))
    assert names[0] == names[1] == (["rollout", "train", "train/dispatch"], ["rollout", "train"])


# ---------------------------------------------------------------------------
# the flags
# ---------------------------------------------------------------------------


def test_the_reference_learning_command_parses():
    """The reference's DreamerV3 learning recipe
    (tests/test_algos/test_learning.py:215-245) is accepted by the port's
    parser as it stands."""
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.utils.parser import DataclassArgumentParser

    argv = ["--env_id", "CartPole-v1", "--num_devices", "1", "--num_envs", "1", "--sync_env", "--seed", "5",
            "--total_steps", "6144", "--learning_starts", "512", "--train_every", "4", "--action_repeat", "1",
            "--mlp_keys", "state", "--exp_name", "x", "--deterministic", "--profile_steps", "3",
            "--memmap_buffer", "--frame_stack_dilation", "2", "--max_episode_steps", "-1", "--remat", "policy"]
    (args,) = DataclassArgumentParser(DreamerV3Args).parse_args_into_dataclasses(argv)
    assert args.sync_env and args.action_repeat == 1 and args.num_devices == 1 and args.remat == "policy"
    with pytest.raises(ValueError, match="remat"):
        DataclassArgumentParser(DreamerV3Args).parse_args_into_dataclasses(["--remat", "sometimes"])


def test_num_devices_is_checked_as_the_reference_checks_it():
    import torch

    from sheeprl_tpu_torch.utils.device import check_num_devices

    cpu = torch.device("cpu")
    assert check_num_devices(-1, cpu) == check_num_devices(1, cpu) == 1
    with pytest.raises(ValueError, match="requested 2 devices but only 1 available"):
        check_num_devices(2, cpu)


def test_memmap_buffer_keeps_the_ring_in_files(tmp_path):
    """`--memmap_buffer`'s storage: `.npy` memmaps under the directory,
    the same rows and samples as plain host storage, and a save / load
    that keeps them."""
    from sheeprl_tpu_torch.data.buffers import AsyncReplayBuffer, ReplayBuffer

    rng = np.random.default_rng(0)
    rows = [{"obs": rng.integers(0, 255, (1, 2, 4, 4, 1), dtype=np.uint8),
             "rewards": rng.normal(size=(1, 2, 1)).astype(np.float32)} for _ in range(6)]
    plain, mapped = AsyncReplayBuffer(8, 2, seed=1), AsyncReplayBuffer(8, 2, seed=1, memmap_dir=str(tmp_path / "a"))
    flat_plain, flat_mapped = ReplayBuffer(8, 2, storage="host"), ReplayBuffer(8, 2, storage="host",
                                                                                memmap_dir=str(tmp_path / "r"))
    for r in rows:
        for b in (plain, mapped, flat_plain, flat_mapped):
            b.add(r)
    assert isinstance(mapped._buf["obs"], np.memmap) and os.path.exists(tmp_path / "a" / "obs.npy")
    assert isinstance(flat_mapped["obs"], np.memmap) and os.path.exists(tmp_path / "r" / "rewards.npy")
    a, b = plain.sample(3, sequence_length=2), mapped.sample(3, sequence_length=2)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    mapped.save(str(tmp_path / "buf.npz"))
    again = AsyncReplayBuffer(8, 2, seed=1, memmap_dir=str(tmp_path / "b"))
    again.load(str(tmp_path / "buf.npz"))
    assert isinstance(again._buf["obs"], np.memmap)
    np.testing.assert_array_equal(again._buf["obs"], mapped._buf["obs"])
    with pytest.raises(ValueError, match="host storage"):
        AsyncReplayBuffer(8, 2, storage="device", memmap_dir=str(tmp_path / "c"))


def _dv3_rows_by_the_old_loop(seed: int, n_envs: int, steps: int, buffer_size: int) -> dict:
    """The replay rows of DreamerV3's random phase as the main wrote them
    before the vector envs: each env built and stepped in turn, reset in
    the same step, its final observation in a terminal row."""
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import _env_actions, _random_actions
    from sheeprl_tpu_torch.data.buffers import AsyncReplayBuffer
    from sheeprl_tpu_torch.utils.env import make_dict_env

    args = DreamerV3Args(env_id="discrete_dummy", cnn_keys=["rgb"], action_repeat=1)
    envs = [make_dict_env("discrete_dummy", seed + i, 0, args)() for i in range(n_envs)]
    rng = np.random.default_rng(seed)
    rb = AsyncReplayBuffer(buffer_size, n_envs)
    obs = [env.reset(seed=seed + i)[0] for i, env in enumerate(envs)]
    step_data = {"rgb": np.stack([o["rgb"] for o in obs]), "dones": np.zeros((n_envs, 1), np.float32),
                 "rewards": np.zeros((n_envs, 1), np.float32), "is_first": np.ones((n_envs, 1), np.float32)}
    for _ in range(steps):
        actions = _random_actions(rng, envs[0].action_space, [2], False, n_envs)
        step_data["actions"] = actions
        rb.add({k: v[None] for k, v in step_data.items()})
        dones, rewards, final_obs = np.zeros(n_envs, np.float32), np.zeros(n_envs, np.float32), {}
        for i, (env, a) in enumerate(zip(envs, _env_actions(actions, [2], False))):
            o, r, term, trunc, _ = env.step(a)
            rewards[i], dones[i] = r, float(term or trunc)
            if dones[i]:
                final_obs[i] = o
                o, _ = env.reset()
            obs[i] = o
        step_data = {"rgb": np.stack([o["rgb"] for o in obs]), "is_first": np.zeros((n_envs, 1), np.float32),
                     "dones": dones[:, None], "rewards": rewards[:, None].astype(np.float32)}
        done_idx = sorted(final_obs)
        if done_idx:
            rb.add({"rgb": np.stack([final_obs[i]["rgb"] for i in done_idx])[None],
                    "dones": np.ones((1, len(done_idx), 1), np.float32),
                    "actions": np.zeros((1, len(done_idx), 2), np.float32),
                    "rewards": step_data["rewards"][done_idx][None],
                    "is_first": np.zeros((1, len(done_idx), 1), np.float32)}, done_idx)
            step_data["rewards"][done_idx] = 0.0
            step_data["dones"][done_idx] = 0.0
            step_data["is_first"][done_idx] = 1.0
    return {k: np.asarray(v) for k, v in rb._buf.items()}


@pytest.mark.timeout(300)
def test_dreamer_replay_rows_stay_those_of_the_per_env_loop(tmp_path):
    """A seeded host-env DreamerV3 run with `--sync_env --action_repeat 1`
    writes the replay rows the main wrote before the vector envs (the loop
    above); the async runner (2 worker processes) writes the same rows."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    tiny = ["--device", "cpu", "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "2",
            "--cnn_channels_multiplier", "2", "--dense_units", "8", "--hidden_size", "8",
            "--recurrent_state_size", "8", "--stochastic_size", "2", "--discrete_size", "2", "--horizon", "2",
            "--per_rank_batch_size", "2", "--per_rank_sequence_length", "2", "--learning_starts", "64",
            "--total_steps", "22", "--buffer_size", "32", "--checkpoint_buffer", "--action_repeat", "1",
            "--bins", "5", "--seed", "3", "--root_dir", str(tmp_path)]
    want = _dv3_rows_by_the_old_loop(3, 2, 11, 16)
    for name, flags in (("sync", ["--sync_env"]), ("async", [])):
        dreamer_v3.main([*tiny, *flags, "--run_name", name])
        with open(tmp_path / name / "metrics.jsonl") as fh:
            done = [json.loads(line) for line in fh][-1]
        assert done["vector_env"] == {"kind": "SyncVectorEnv" if name == "sync" else "AsyncVectorEnv",
                                      "workers": 0 if name == "sync" else 2}
        with np.load(tmp_path / name / "checkpoints" / "ckpt_11_buffer.npz") as saved:
            for k, rows in want.items():
                got = np.concatenate([saved[f"b{i}_buf_{k}"] for i in range(2)], axis=1)
                np.testing.assert_array_equal(got, rows, err_msg=f"{name} {k}")


CLI_RUNS = {
    "ppo mask_vel": ["ppo", "--env_id", "CartPole-v1", "--mask_vel", "--num_envs", "2", "--sync_env",
                     "--action_repeat", "2", "--max_episode_steps", "20", "--rollout_steps", "8",
                     "--per_rank_batch_size", "4", "--update_epochs", "1", "--total_steps", "16"],
    "ppo gray stack": ["ppo", "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--grayscale_obs", "--screen_size",
                       "48", "--frame_stack", "3", "--frame_stack_dilation", "2", "--num_envs", "2",
                       "--rollout_steps", "8", "--per_rank_batch_size", "8", "--update_epochs", "1",
                       "--total_steps", "16", "--cnn_features_dim", "16", "--memmap_buffer"],
    "sac repeat memmap": ["sac", "--num_envs", "2", "--sync_env", "--action_repeat", "2", "--memmap_buffer",
                          "--actor_hidden_size", "8", "--critic_hidden_size", "8", "--per_rank_batch_size", "8",
                          "--learning_starts", "8", "--buffer_size", "64", "--total_steps", "40"],
    "dreamer_v3 memmap": ["dreamer_v3", "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "1",
                          "--memmap_buffer", "--cnn_channels_multiplier", "2", "--dense_units", "8",
                          "--hidden_size", "8", "--recurrent_state_size", "8", "--stochastic_size", "2",
                          "--discrete_size", "2", "--horizon", "2", "--per_rank_batch_size", "2",
                          "--per_rank_sequence_length", "2", "--learning_starts", "8", "--total_steps", "12",
                          "--train_every", "2", "--buffer_size", "32", "--bins", "5"],
}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_mains_take_the_reference_env_flags(name, tmp_path):
    """The mains through the CLI on the CPU with the reference's env flags:
    velocity masking, action repeat and a time limit (PPO on CartPole),
    gray, resized, dilated stacked frames in 2 worker processes (PPO on
    pixels), host memmap replay storage (PPO, SAC, DreamerV3)."""
    from sheeprl_tpu_torch.cli import run

    run([*CLI_RUNS[name], "--device", "cpu", "--root_dir", str(tmp_path), "--run_name", "r"])
    with open(tmp_path / "r" / "metrics.jsonl") as fh:
        done = [json.loads(line) for line in fh][-1]
    assert done["event"] == "done" and all(np.isfinite(done["test_returns"]))
    args = json.loads((tmp_path / "r" / "args.json").read_text())
    for flag in ("action_repeat", "max_episode_steps", "sync_env", "memmap_buffer", "frame_stack_dilation"):
        assert flag in args
    if "memmap" in name and name != "ppo gray stack":
        assert any(f.endswith(".npy") for f in os.listdir(tmp_path / "r" / "memmap_buffer"))
    if name == "ppo mask_vel":
        # the time limit of 20 // 2 player steps ends the greedy test episode
        assert done["test_returns"][0] <= 20.0


def test_num_devices_above_one_is_refused_until_the_mesh_is_ported(monkeypatch):
    import torch

    from sheeprl_tpu_torch.utils.device import check_num_devices

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(NotImplementedError, match="Queue A item 8"):
        check_num_devices(2, torch.device("cuda"))
    assert check_num_devices(-1, torch.device("cuda")) == check_num_devices(1, torch.device("cuda")) == 1


def _fails_to_build(seed: int):
    raise OSError(f"no env for seed {seed}")


def test_async_vector_env_reports_an_env_that_fails_to_build():
    from sheeprl_tpu_torch.envs.vector import AsyncVectorEnv

    with pytest.raises(RuntimeError, match="(?s)worker 0 raised:.*OSError: no env for seed 5"):
        AsyncVectorEnv([functools.partial(_fails_to_build, 5)])
