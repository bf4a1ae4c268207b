"""The port's batched device envs (`sheeprl_tpu_torch/envs/device/`) against
the reference's pure-JAX envs (`sheeprl_tpu/envs/jax/`) on the CPU.

- Each env's step from the same states (carried by `interop`), over random
  states and every action (CartPole's two, a grid of torques past +-2,
  pixeltoy's five): CartPole and Pendulum observations and rewards to 1e-6
  absolute (an f32 `sin`/`cos` may differ by an ulp between XLA and
  torch) or, where a value passes 4 (Pendulum's costs reach 16, its
  episode returns more), two f32 ulps of it (rtol 2.4e-7: at 16 one ulp is
  1.9e-6), pixeltoy's frames and rewards exactly, every flag exactly;
- spaces, shapes and dtypes as the reference's `test_vmap_shapes_and_dtypes`;
- auto-reset: with the reference's own fresh states (rebuilt from its key
  tree, `core.py:128-134`) passed in, `VecDeviceEnv.step` follows
  `VecJaxEnv.step` over a run that crosses terminations and the time
  limit, teacher-forced (each step from the reference's state, carried by
  `interop`, as the reference's own parity tests step from gymnasium's):
  observations, `final_obs`, rewards, flags, and the episode stats and
  their reset, as above;
- the reference's `test_autoreset_resets_state_and_stats`,
  `test_truncation_at_max_episode_steps` and
  `test_pixeltoy_reaches_goal_with_scripted_actions`, on the port;
- the registry (case-insensitive, the reference's error message), the host
  twin of pixeltoy (`make_dict_env`, the batched env's own dynamics at
  N = 1) and `interop`'s carry of a `VecEnvState`.

No draw is compared draw for draw: jax.random and torch differ.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_interop import jax_flat

ENV_IDS = ["CartPole-v1", "Pendulum-v1", "pixeltoy"]
ATOL, RTOL = 1e-6, 2.4e-7  # 1e-6, or two f32 ulps of a value past 4


def _envs(env_id: str, **kw):
    """(the reference's env, the port's env) of one id and config."""
    from sheeprl_tpu.envs.jax import make_jax_env
    from sheeprl_tpu_torch.envs.device import make_device_env

    return make_jax_env(env_id, **kw), make_device_env(env_id, **kw)


def _random_states(env_id: str, n: int, seed: int) -> dict[str, np.ndarray]:
    """n random env states in the reference's field layout, the first four a
    step short of the time limit."""
    rng = np.random.default_rng(seed)
    limit = {"CartPole-v1": 500, "Pendulum-v1": 200, "pixeltoy": 128}[env_id]
    t = rng.integers(0, limit, n).astype(np.int32)
    t[:4] = limit - 1
    if env_id == "CartPole-v1":
        state = rng.normal(size=(n, 4)) * [1.0, 1.5, 0.1, 1.5]
        return {"state": state.astype(np.float32), "t": t}
    if env_id == "Pendulum-v1":
        state = np.stack([rng.uniform(-7.0, 7.0, n), rng.uniform(-8.0, 8.0, n)], -1)
        return {"state": state.astype(np.float32), "t": t}
    agent = rng.integers(0, 16, (n, 2)).astype(np.int32)
    goal = rng.integers(0, 16, (n, 2)).astype(np.int32)
    goal[4:12] = agent[4:12] + [[0, 1], [0, -1], [1, 0], [-1, 0]] * 2  # one move from the goal
    return {"agent": agent, "goal": goal, "t": t}


def _actions(env_id: str, n: int) -> list[np.ndarray]:
    """Every action of the env, each taken by all n envs (a grid of torques
    for Pendulum, past the +-2 clip)."""
    if env_id == "CartPole-v1":
        return [np.full(n, a, np.int32) for a in (0, 1)]
    if env_id == "Pendulum-v1":
        return [np.full((n, 1), u, np.float32) for u in (-3.0, -2.0, -0.7, 0.0, 0.3, 1.999, 2.5)]
    return [np.full(n, a, np.int32) for a in range(5)]


def _close(got: torch.Tensor, want, exact: bool, what: str) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    if exact or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("env_id", ENV_IDS)
def test_step_matches_the_reference_from_the_same_states(env_id):
    from sheeprl_tpu_torch.interop import env_state_from_jax

    ref, port = _envs(env_id)
    n = 64
    raw = _random_states(env_id, n, seed=1)
    ref_state = type(jax.vmap(ref.reset)(jax.random.split(jax.random.PRNGKey(0), n))[0])(
        **{k: jnp.asarray(v) for k, v in raw.items()})
    port_state = env_state_from_jax(port, raw)
    step = jax.jit(jax.vmap(ref.step))
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    exact = env_id == "pixeltoy"
    flips = 0
    for a in _actions(env_id, n):
        r_state, r_obs, r_rew, r_term, r_trunc = step(ref_state, jnp.asarray(a), keys)
        p_state, p_obs, p_rew, p_term, p_trunc = port.step(port_state, torch.from_numpy(a))
        for k in r_obs:
            _close(p_obs[k], r_obs[k], exact, f"obs {k}, action {a[0]}")
        _close(p_rew, r_rew, exact, f"reward, action {a[0]}")
        for name, got, want in (("terminated", p_term, r_term), ("truncated", p_trunc, r_trunc)):
            same = got.numpy() == np.asarray(want)
            if not same.all():  # an ulp from a threshold: name the env and step
                print(f"{env_id} {name} differs at envs {np.flatnonzero(~same)}, action {a[0]}")
                flips += int((~same).sum())
        for k, v in jax_flat(r_state).items():
            _close(getattr(p_state, k), v, exact, f"state {k}, action {a[0]}")
    assert flips == 0
    assert np.asarray(r_trunc).any()  # the limit, and for CartPole and pixeltoy a termination
    if env_id != "Pendulum-v1":
        assert 0 < int(np.asarray(r_term).sum()) < n


@pytest.mark.parametrize("env_id,obs_key,shape,dtype", [
    ("CartPole-v1", "state", (4,), torch.float32),
    ("Pendulum-v1", "state", (3,), torch.float32),
    ("pixeltoy", "rgb", (64, 64, 3), torch.uint8),
])
def test_vec_shapes_dtypes_and_spaces(env_id, obs_key, shape, dtype):
    from sheeprl_tpu.envs.jax import VecJaxEnv
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.device import VecDeviceEnv

    ref, port = _envs(env_id)
    n = 5
    venv = VecDeviceEnv(port, n, "cpu")
    state, obs = venv.reset(torch.Generator().manual_seed(0))
    assert obs[obs_key].shape == (n,) + shape and obs[obs_key].dtype == dtype
    space = venv.single_action_space
    actions = (torch.zeros((n,), dtype=torch.int32) if isinstance(space, spaces.Discrete)
               else torch.zeros((n,) + space.shape))
    fresh = venv.draw_resets(torch.Generator().manual_seed(1), 1)
    from sheeprl_tpu_torch.envs.device.core import tree_index

    state2, obs2, reward, done, info = venv.step(state, actions, tree_index(fresh, 0))
    assert obs2[obs_key].shape == (n,) + shape and obs2[obs_key].dtype == dtype
    assert reward.shape == (n,) and reward.dtype == torch.float32
    assert done.shape == (n,) and done.dtype == torch.bool
    assert info["final_obs"][obs_key].shape == (n,) + shape
    assert state2.ep_length.shape == (n,) and state2.ep_length.dtype == torch.int32
    # the spaces are the reference's
    ref_space = VecJaxEnv(env=ref, num_envs=n)
    r_obs, p_obs = ref_space.single_observation_space[obs_key], venv.single_observation_space.spaces[obs_key]
    assert tuple(p_obs.shape) == tuple(r_obs.shape) == shape and np.dtype(p_obs.dtype) == r_obs.dtype
    np.testing.assert_array_equal(np.broadcast_to(p_obs.low, shape), r_obs.low)
    np.testing.assert_array_equal(np.broadcast_to(p_obs.high, shape), r_obs.high)
    r_act, p_act = ref_space.single_action_space, venv.single_action_space
    if isinstance(p_act, spaces.Discrete):
        assert p_act.n == r_act.n
    else:
        assert tuple(p_act.shape) == r_act.shape
        np.testing.assert_array_equal(np.broadcast_to(p_act.low, p_act.shape), r_act.low)
        np.testing.assert_array_equal(np.broadcast_to(p_act.high, p_act.shape), r_act.high)


def _ref_fresh(ref, key, n: int) -> dict[str, np.ndarray]:
    """The fresh states `VecJaxEnv.step(..., key)` resets into (core.py:128-134)."""
    _, reset_key = jax.random.split(key)
    return jax_flat(jax.vmap(ref.reset)(jax.random.split(reset_key, n))[0])


@pytest.mark.parametrize("env_id,kw", [
    ("CartPole-v1", {"max_episode_steps": 12}),  # terminations and the limit
    ("Pendulum-v1", {"max_episode_steps": 7}),  # truncation only
    ("pixeltoy", {"size": 16, "grid": 4, "max_episode_steps": 9}),  # goals and the limit
])
def test_autoreset_follows_the_reference_with_its_fresh_states(env_id, kw):
    from sheeprl_tpu.envs.jax import VecJaxEnv
    from sheeprl_tpu_torch.envs.device import VecDeviceEnv
    from sheeprl_tpu_torch.interop import env_state_from_jax, vec_env_state_from_jax

    ref, port = _envs(env_id, **kw)
    n = 6
    rvenv, pvenv = VecJaxEnv(env=ref, num_envs=n), VecDeviceEnv(port, n, "cpu")
    r_state, r_obs = jax.jit(rvenv.reset)(jax.random.PRNGKey(0))
    p_state = vec_env_state_from_jax(port, jax_flat(r_state))
    rstep = jax.jit(rvenv.step)
    rng = np.random.default_rng(2)
    key = jax.random.PRNGKey(3)
    exact = env_id == "pixeltoy"
    done_steps = term_steps = trunc_steps = 0
    for t in range(45):
        key, k = jax.random.split(key)
        if env_id == "CartPole-v1":
            a = rng.integers(0, 2, n).astype(np.int32)
        elif env_id == "Pendulum-v1":
            a = rng.uniform(-2.5, 2.5, (n, 1)).astype(np.float32)
        else:
            a = rng.integers(0, 5, n).astype(np.int32)
        r_state, r_obs, r_rew, r_done, r_info = rstep(r_state, jnp.asarray(a), k)
        fresh = env_state_from_jax(port, _ref_fresh(ref, k, n))
        p_state, p_obs, p_rew, p_done, p_info = pvenv.step(p_state, torch.from_numpy(a), fresh)
        what = f"{env_id} step {t}"
        for k_ in r_obs:
            _close(p_obs[k_], r_obs[k_], exact, f"obs {k_}, {what}")
            _close(p_info["final_obs"][k_], r_info["final_obs"][k_], exact, f"final_obs {k_}, {what}")
        _close(p_rew, r_rew, exact, f"reward, {what}")
        _close(p_done, r_done, True, f"done, {what}")
        for name in ("terminated", "truncated", "ep_length"):
            _close(p_info[name], r_info[name], True, f"{name}, {what}")
        _close(p_info["ep_return"], r_info["ep_return"], exact, f"info ep_return, {what}")
        _close(p_state.ep_return, r_state.ep_return, exact, f"ep_return, {what}")
        _close(p_state.ep_length, r_state.ep_length, True, f"ep_length, {what}")
        for k_, v in jax_flat(r_state.env_state).items():
            _close(getattr(p_state.env_state, k_), v, exact, f"state {k_}, {what}")
        p_state = vec_env_state_from_jax(port, jax_flat(r_state))  # the next step from the same state
        done_steps += int(np.asarray(r_done).any())
        term_steps += int(np.asarray(r_info["terminated"]).any())
        trunc_steps += int(np.asarray(r_info["truncated"]).any())
    assert done_steps > 0 and trunc_steps > 0
    if env_id != "Pendulum-v1":
        assert term_steps > 0


def test_autoreset_resets_state_and_stats():
    """The reference's test (test_jax_envs.py:144) on the port: CartPole
    driven to termination with a constant action resets the done env's
    state, step counter and episode stats in the same step, reports the
    finished episode in `info`, and returns the reset observation while
    `final_obs` is the out-of-bounds one."""
    from sheeprl_tpu_torch.envs.device import DeviceCartPole, VecDeviceEnv
    from sheeprl_tpu_torch.envs.device.core import tree_index

    n = 4
    venv = VecDeviceEnv(DeviceCartPole(), n, "cpu")
    gen = torch.Generator().manual_seed(0)
    state, obs = venv.reset(gen)
    fresh = venv.draw_resets(gen, 60)
    for t in range(60):
        state, obs, reward, done, info = venv.step(state, torch.ones(n, dtype=torch.int32), tree_index(fresh, t))
        if done.any():
            i = int(done.to(torch.uint8).argmax())
            assert float(state.ep_return[i]) == 0.0 and int(state.ep_length[i]) == 0
            assert int(state.env_state.t[i]) == 0
            assert float(info["ep_return"][i]) == t + 1 and int(info["ep_length"][i]) == t + 1
            assert torch.all(obs["state"][i].abs() <= 0.05)
            final = info["final_obs"]["state"][i]
            assert abs(float(final[2])) > 12 * 2 * np.pi / 360 or abs(float(final[0])) > 2.4
            assert torch.equal(obs["state"][i], fresh.state[t, i])
            return
    pytest.fail("constant-action cartpole never terminated in 60 steps")


def test_truncation_at_max_episode_steps():
    from sheeprl_tpu_torch.envs.device import DevicePendulum, VecDeviceEnv
    from sheeprl_tpu_torch.envs.device.core import tree_index

    venv = VecDeviceEnv(DevicePendulum(max_episode_steps=7), 2, "cpu")
    gen = torch.Generator().manual_seed(0)
    state, _ = venv.reset(gen)
    fresh = venv.draw_resets(gen, 7)
    for t in range(1, 8):
        state, _, _, done, info = venv.step(state, torch.zeros((2, 1)), tree_index(fresh, t - 1))
        if t < 7:
            assert not done.any()
    assert done.all() and info["truncated"].all() and not info["terminated"].any()
    assert (state.env_state.t == 0).all()


def test_pixeltoy_reaches_goal_with_scripted_actions():
    from sheeprl_tpu_torch.envs.device import DevicePixelToy

    env = DevicePixelToy(size=16, grid=4, max_episode_steps=50)
    state = env.draw_resets(torch.Generator().manual_seed(2), (1,))
    obs = env.observe(state)
    assert obs["rgb"].dtype == torch.uint8 and obs["rgb"].shape == (1, 16, 16, 3)
    assert not (state.agent == state.goal).all()  # the spawn re-rolls a goal on the agent
    for _ in range(12):
        dr = int(state.goal[0, 0] - state.agent[0, 0])
        dc = int(state.goal[0, 1] - state.agent[0, 1])
        if dr != 0:
            a = 2 if dr > 0 else 1
        elif dc != 0:
            a = 4 if dc > 0 else 3
        else:
            break
        state, obs, reward, term, trunc = env.step(state, torch.tensor([a], dtype=torch.int32))
        if bool(term[0]):
            assert float(reward[0]) == 1.0
            return
    pytest.fail("scripted manhattan walk never reached the goal")


def test_pixeltoy_spawn_rerolls_a_goal_on_the_agent_as_the_reference():
    """Many draws: no goal on its agent, every cell reachable, the render's
    blocks where the cells are (agent red, goal green, blue empty)."""
    from sheeprl_tpu_torch.envs.device import DevicePixelToy

    env = DevicePixelToy()
    state = env.draw_resets(torch.Generator().manual_seed(3), (4096,))
    assert not (state.agent == state.goal).all(-1).any()
    assert set(state.goal.flatten().tolist()) == set(range(16))
    frame = env.render(state)
    assert frame.shape == (4096, 64, 64, 3) and frame.dtype == torch.uint8
    assert int(frame[..., 2].max()) == 0
    assert (frame[..., 0] == 255).sum((1, 2)).eq(16).all() and (frame[..., 1] == 255).sum((1, 2)).eq(16).all()
    i = 7
    r, c = state.agent[i].tolist()
    assert frame[i, 4 * r:4 * r + 4, 4 * c:4 * c + 4, 0].eq(255).all()


def test_registry_and_its_error_message():
    from sheeprl_tpu.envs.jax import make_jax_env
    from sheeprl_tpu_torch.envs.device import DevicePixelToy, has_device_env, make_device_env

    assert all(has_device_env(e) for e in ("CartPole-v1", "cartpole-v1", "PENDULUM-V1", "pixeltoy", "PixelToy-v0"))
    assert not has_device_env("discrete_dummy")
    assert isinstance(make_device_env("pixeltoy-v0", max_episode_steps=5), DevicePixelToy)
    with pytest.raises(ValueError) as ref_err:
        make_jax_env("discrete_dummy")
    with pytest.raises(ValueError) as port_err:
        make_device_env("discrete_dummy")
    assert str(port_err.value) == str(ref_err.value)


def test_pixeltoy_host_twin_steps_the_device_dynamics():
    """`make_dict_env("pixeltoy")` is the host twin: numpy frames under
    `rgb`, gym-style returns, the batched env's own step at N = 1 from the
    same state, and the same episode from the same seed."""
    from sheeprl_tpu_torch.envs.device import DevicePixelToy, HostTwin
    from sheeprl_tpu_torch.utils.env import make_dict_env

    args = type("A", (), {"cnn_keys": None, "mlp_keys": None, "screen_size": 64})()
    env = make_dict_env("pixeltoy", 3, rank=0, args=args)()
    assert isinstance(env, HostTwin) and args.cnn_keys == ["rgb"]
    obs, _ = env.reset(seed=3)
    assert obs["rgb"].shape == (64, 64, 3) and obs["rgb"].dtype == np.uint8
    device_env = DevicePixelToy()
    state = device_env.draw_resets(torch.Generator().manual_seed(3), (1,))
    np.testing.assert_array_equal(device_env.observe(state)["rgb"][0].numpy(), obs["rgb"])
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = int(rng.integers(0, 5))
        obs, reward, term, trunc, _ = env.step(a)
        state, dobs, drew, dterm, dtrunc = device_env.step(state, torch.tensor([a], dtype=torch.int32))
        np.testing.assert_array_equal(dobs["rgb"][0].numpy(), obs["rgb"])
        assert isinstance(reward, float) and reward == float(drew[0]) and term == bool(dterm[0])
        assert trunc == bool(dtrunc[0])
        if term or trunc:
            break
    assert env.render().shape == (64, 64, 3)
    with pytest.raises(ValueError, match="screen_size"):
        make_dict_env("pixeltoy", 0, rank=0, args=type("A", (), {"cnn_keys": None, "screen_size": 32})())()


def test_vec_env_state_carries_across_from_the_reference():
    from sheeprl_tpu.envs.jax import JaxPixelToy, VecJaxEnv
    from sheeprl_tpu_torch.envs.device import DevicePixelToy, PixelToyState
    from sheeprl_tpu_torch.interop import vec_env_state_from_jax

    state, _ = VecJaxEnv(env=JaxPixelToy(), num_envs=3).reset(jax.random.PRNGKey(4))
    port = vec_env_state_from_jax(DevicePixelToy(), jax_flat(state))
    assert isinstance(port.env_state, PixelToyState)
    for k in ("agent", "goal", "t"):
        np.testing.assert_array_equal(getattr(port.env_state, k).numpy(), np.asarray(getattr(state.env_state, k)))
        assert getattr(port.env_state, k).dtype == torch.int32
    assert port.ep_return.dtype == torch.float32 and port.ep_length.dtype == torch.int32
    with pytest.raises(KeyError):
        vec_env_state_from_jax(DevicePixelToy(), {"env_state": {"agent": np.zeros((3, 2), np.int32)},
                                                  "ep_return": np.zeros(3), "ep_length": np.zeros(3)})
