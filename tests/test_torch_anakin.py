"""The Anakin path of the port (`envs/device/rollout.py`, `parallel/anakin.py`,
`AsyncReplayBuffer(storage="device")`, `--env_backend jax` in `ppo` and
`dreamer_v3`) against the reference's (`sheeprl_tpu/envs/jax/rollout.py`)
on the CPU, at tiny sizes.

- The collectors, teacher-forced: every draw of the reference's
  `make_ppo_collector` (T = 16, N = 8, on CartPole, Pendulum and pixeltoy)
  and of its `make_dreamer_collector` (pixeltoy, tiny widths, the policy
  and the random phase) is rebuilt from its key tree and passed to the
  port's: PPO's action noise in `draw_noise`'s layout, the player's
  uniforms in `noisy_step`'s (the posterior's and each head's Gumbel
  uniforms, the exploration's index and swap), the random phase's
  actions, and every step's fresh reset states. The agents' parameters are
  carried by `interop`, the starting carry too. The trajectory, the final
  carry and the episode dict agree at the PPO agent test's rtol 1e-5 /
  atol 1e-5 (the player's states at the player test's atol 1e-5), frames,
  the actions chosen and flags exactly (DreamerV3's action rows are the
  actor's straight-through samples, one-hot + probs - probs, which round
  an ulp apart where the probs do: their values at 1e-5). A flag that flips because a value sits an ulp
  from a threshold is printed with its step.
- A T-step collector equals T one-step collectors bit for bit, rows, carry
  and device ring (the reference's `test_ppo_collector_bit_exact_vs_step_
  by_step` and `test_dreamer_rollout_ring_bit_exact_vs_step_by_step`).
- The device ring: `reserve`/`add_direct` give the reference's ring and
  heads, the port's host ring's rows, and the same samples (injected and
  drawn) as host storage; `save` on one storage and `load` on the other
  sample the same; `reserve`/`add_direct` raise on host storage.
- The mains on the CPU: `ppo --env_backend jax --dry_run` on CartPole-v1,
  Pendulum-v1 and pixeltoy; `dreamer_v3 --env_backend jax` on pixeltoy and
  CartPole-v1, which checkpoints; the plan's static mode against the
  direct calls through both CLIs; a PPO run resumed from `ckpt_1` equal to
  the uninterrupted run's second update bit for bit; `--env_backend gpu`
  and an env without a device twin refused; `--env_backend host` bit for
  bit as without the flag; the `Anakin/*` gauges are the reference's.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_interop import TINY_DV3, jax_flat

T, N = 16, 8
RTOL = ATOL = 1e-5
PPO_KW = dict(dense_units=8, mlp_layers=1, mlp_features_dim=8, cnn_features_dim=16)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _venvs(env_id: str, n: int = N, **kw):
    """(the reference's VecJaxEnv, the port's VecDeviceEnv on the CPU)."""
    from sheeprl_tpu.envs.jax import VecJaxEnv, make_jax_env
    from sheeprl_tpu_torch.envs.device import VecDeviceEnv, make_device_env

    return VecJaxEnv(env=make_jax_env(env_id, **kw), num_envs=n), VecDeviceEnv(make_device_env(env_id, **kw), n, "cpu")


def _fresh(ref_env, k_step, n: int) -> dict[str, np.ndarray]:
    """The reset states `VecJaxEnv.step(..., k_step)` draws (core.py:128-134)."""
    _, reset_key = jax.random.split(k_step)
    return jax_flat(jax.vmap(ref_env.reset)(jax.random.split(reset_key, n))[0])


def _stack(rows: list[dict]) -> dict[str, np.ndarray]:
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def _cmp(got: torch.Tensor, want, what: str, exact: bool = False) -> None:
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    if exact or got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _flag_flips(got: torch.Tensor, want, what: str) -> int:
    """Flags compared exactly; each flip printed with its step."""
    same = got.numpy() == np.asarray(want)
    for t, n in zip(*np.nonzero(~same.reshape(same.shape[0], -1))):
        print(f"{what}: flag flipped at step {t}, env {n}")
    return int((~same).sum())


# ---------------------------------------------------------------------------
# PPO's collector, teacher-forced
# ---------------------------------------------------------------------------


def _ppo_agents(venv_ref, venv_port):
    from sheeprl_tpu.algos.ppo.agent import PPOAgent as RefAgent
    from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent
    from sheeprl_tpu_torch.algos.ppo.ppo import actions_dim_of
    from sheeprl_tpu_torch.interop import ppo_agent_from_jax

    space = venv_port.single_observation_space.spaces
    cnn = [k for k, s in space.items() if len(s.shape) == 3]
    mlp = [k for k, s in space.items() if len(s.shape) == 1]
    actions_dim, cont = actions_dim_of(venv_port.single_action_space)
    ref = RefAgent.init(jax.random.PRNGKey(1), actions_dim, venv_ref.single_observation_space.spaces, cnn, mlp,
                        is_continuous=cont, **PPO_KW)
    port = ppo_agent_from_jax(PPOAgent(actions_dim, space, cnn, mlp, is_continuous=cont, **PPO_KW), jax_flat(ref))
    return ref, port, actions_dim, cont


def _ppo_draws(ref_env, key, steps: int, n: int, actions_dim, cont: bool):
    """Every draw of the reference's PPO collector (`rollout.py:134-160`):
    a step's key splits into (carry, act, step); the agent's noise comes
    from the act key (a Gumbel a discrete head, from `split(k_act, heads)`,
    or one standard normal), the reset states from the step key."""
    noise, fresh = [], []
    k = key
    for _ in range(steps):
        k, k_act, k_step = jax.random.split(k, 3)
        if cont:
            noise.append(np.asarray(jax.random.normal(k_act, (n, sum(actions_dim)))))
        else:
            keys = jax.random.split(k_act, len(actions_dim))
            noise.append(np.concatenate([np.asarray(jax.random.gumbel(kk, (n, d)))
                                         for kk, d in zip(keys, actions_dim)], -1))
        fresh.append(_fresh(ref_env, k_step, n))
    return np.stack(noise), _stack(fresh)


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1", "pixeltoy"])
def test_ppo_collector_matches_the_reference_teacher_forced(env_id):
    from sheeprl_tpu.envs.jax import PPOCollectorCarry as RefCarry
    from sheeprl_tpu.envs.jax import make_ppo_collector as ref_collector
    from sheeprl_tpu_torch.envs.device.rollout import make_ppo_collector
    from sheeprl_tpu_torch.interop import collector_carry_from_jax, env_state_from_jax

    rvenv, pvenv = _venvs(env_id)
    ref_agent, agent, actions_dim, cont = _ppo_agents(rvenv, pvenv)
    state, obs = jax.jit(rvenv.reset)(jax.random.PRNGKey(3))
    ref_carry = RefCarry(vec=state, obs=obs, prev_done=jnp.zeros((N, 1), jnp.float32))
    carry = collector_carry_from_jax(pvenv.env, jax_flat(ref_carry))
    key = jax.random.PRNGKey(9)
    r_carry, r_traj, r_ep = jax.jit(ref_collector(rvenv, T, actions_dim, cont))(ref_agent, ref_carry, key)
    noise, fresh = _ppo_draws(rvenv.env, key, T, N, actions_dim, cont)
    traj, ep = make_ppo_collector(pvenv, T, actions_dim, cont)(agent, carry, env_state_from_jax(pvenv.env, fresh),
                                                              _t(noise))
    exact = env_id == "pixeltoy"
    assert set(traj) == set(r_traj)
    flips = _flag_flips(traj["dones"], r_traj["dones"], f"{env_id} dones")
    for k in traj:
        if k != "dones":
            _cmp(traj[k], r_traj[k], f"{env_id} traj {k}", exact=exact and k in ("rgb", "rewards"))
    if not cont:
        _cmp(traj["actions"], r_traj["actions"], f"{env_id} actions", exact=True)
    for k, v in jax_flat(r_carry).items():
        node = carry
        for part in k.split("."):
            node = node[part] if isinstance(node, dict) else getattr(node, part)
        _cmp(node, v, f"{env_id} carry {k}", exact=exact)
    _cmp(ep["episodes"], r_ep["episodes"], f"{env_id} episodes", exact=True)
    for k in ("return_sum", "length_sum"):
        _cmp(ep[k], r_ep[k], f"{env_id} ep {k}")
    assert flips == 0
    if env_id == "pixeltoy":
        assert traj["rgb"].dtype == torch.uint8 and int(traj["rgb"].max()) == 255


# ---------------------------------------------------------------------------
# DreamerV3's collector, teacher-forced
# ---------------------------------------------------------------------------

PIX_ACTIONS = (5,)


def _pixel_players():
    """(the reference's tiny player, the port's with its parameters) over
    pixeltoy's frames alone."""
    import gymnasium as gym

    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerDV3 as JaxPlayer
    from sheeprl_tpu.algos.dreamer_v3.agent import build_models as jax_build
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args as JaxArgs
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3, build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop import load_jax_params

    common = dict(stochastic_size=TINY_DV3["stochastic_size"], discrete_size=TINY_DV3["discrete_size"],
                  recurrent_state_size=TINY_DV3["recurrent_state_size"], is_continuous=False)
    wm, jactor, _, _ = jax_build(jax.random.PRNGKey(0), list(PIX_ACTIONS), False, JaxArgs(**TINY_DV3),
                                 {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)}, ["rgb"], [])
    jplayer = JaxPlayer(encoder=wm.encoder, rssm=wm.rssm, actor=jactor, actions_dim=PIX_ACTIONS, **common)
    twm, tactor, _, _ = build_models(torch.Generator().manual_seed(0), list(PIX_ACTIONS), False,
                                     DreamerV3Args(**TINY_DV3), {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)},
                                     ["rgb"], [])
    tplayer = PlayerDV3(twm.encoder, twm.rssm, tactor, actions_dim=PIX_ACTIONS, **common)
    load_jax_params(tplayer, jax_flat(jplayer))
    return jplayer, tplayer


def _tiny_uniform(key, shape) -> np.ndarray:
    """The uniforms under `jax.random.gumbel(key, shape)` (its "low" mode:
    -log(-log(U)), U uniform in [tiny, 1))."""
    return np.asarray(jax.random.uniform(key, shape, minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))


def _dreamer_draws(ref_env, key, steps: int, n: int, random_actions: bool):
    """Every draw of the reference's DreamerV3 collector (`rollout.py:
    198-236`), in the port's layouts: a step's act key becomes the random
    phase's one-hot actions (`random_action_sampler`: a `randint` a head
    from `split(k_act, heads)`), or `PlayerDV3.step`'s draws (`agent.py:
    820`: `split(k_act, 3)` into the posterior's Gumbel, the actor heads'
    Gumbels from a chain of splits, and a head's exploration `randint` and
    swap uniform from `split(key, 3)`) laid out as `noisy_step`'s uniforms:
    the Gumbels' uniforms, then per head the swapped-in index as (i + 0.5)
    / A (which `noisy_step` floors back to i) and the swap uniform."""
    s, d = TINY_DV3["stochastic_size"], TINY_DV3["discrete_size"]
    draws, fresh = [], []
    k = key
    for _ in range(steps):
        k, k_act, k_step = jax.random.split(k, 3)
        if random_actions:
            keys = jax.random.split(k_act, len(PIX_ACTIONS))
            draws.append(np.concatenate([np.eye(a, dtype=np.float32)[np.asarray(jax.random.randint(kk, (n,), 0, a))]
                                         for kk, a in zip(keys, PIX_ACTIONS)], -1))
        else:
            k_repr, k_heads, k_expl = jax.random.split(k_act, 3)
            parts = [_tiny_uniform(k_repr, (n, s, d)).reshape(n, s * d)]
            for a in PIX_ACTIONS:
                k_heads, sub = jax.random.split(k_heads)
                parts.append(_tiny_uniform(sub, (n, a)))
            for a in PIX_ACTIONS:
                k_expl, k_u, k_s = jax.random.split(k_expl, 3)
                idx = np.asarray(jax.random.randint(k_u, (n,), 0, a))
                parts.append(((idx + 0.5) / a).astype(np.float32)[:, None])
                parts.append(np.asarray(jax.random.uniform(k_s, (n,)))[:, None])
            draws.append(np.concatenate(parts, -1))
        fresh.append(_fresh(ref_env, k_step, n))
    return np.stack(draws), _stack(fresh)


@pytest.mark.parametrize("phase", ["policy", "random"])
def test_dreamer_collector_matches_the_reference_teacher_forced(phase):
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerState as RefPlayerState
    from sheeprl_tpu.algos.dreamer_v3.utils import make_device_preprocess as ref_preprocess
    from sheeprl_tpu.envs.jax import DreamerCollectorCarry as RefCarry
    from sheeprl_tpu.envs.jax import make_dreamer_collector as ref_collector
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import make_device_preprocess
    from sheeprl_tpu_torch.envs.device.rollout import make_dreamer_collector
    from sheeprl_tpu_torch.interop import collector_carry_from_jax, env_state_from_jax

    random_actions = phase == "random"
    rvenv, pvenv = _venvs("pixeltoy", max_episode_steps=6)  # episodes end inside the chunk
    jplayer, player = _pixel_players()
    state, obs = jax.jit(rvenv.reset)(jax.random.PRNGKey(5))
    ref_carry = RefCarry(vec=state, obs=obs, prev_reward=jnp.zeros((N, 1)), prev_done=jnp.zeros((N, 1)),
                         is_first=jnp.ones((N, 1)))
    carry = collector_carry_from_jax(pvenv.env, jax_flat(ref_carry))
    rng = np.random.default_rng(6)  # a player state mid-episode
    jstate = RefPlayerState(**{k: jnp.asarray(v) for k, v in {
        "actions": np.eye(5, dtype=np.float32)[rng.integers(0, 5, N)],
        "recurrent_state": rng.normal(size=(N, TINY_DV3["recurrent_state_size"])).astype(np.float32) * 0.5,
        "stochastic_state": np.eye(TINY_DV3["discrete_size"], dtype=np.float32)[
            rng.integers(0, TINY_DV3["discrete_size"], (N, TINY_DV3["stochastic_size"]))].reshape(N, -1)}.items()})
    pstate = PlayerState(**{k: _t(v) for k, v in jax_flat(jstate).items()})
    key, expl = jax.random.PRNGKey(11), 0.3
    collect = jax.jit(ref_collector(rvenv, T, PIX_ACTIONS, False, ref_preprocess(["rgb"]), clip_rewards=True,
                                    random_actions=random_actions))
    r_pstate, r_carry, r_traj, r_ep = collect(jplayer, jstate, ref_carry, key, jnp.float32(expl))
    draws, fresh = _dreamer_draws(rvenv.env, key, T, N, random_actions)
    traj, ep = make_dreamer_collector(pvenv, T, PIX_ACTIONS, False, make_device_preprocess(["rgb"]),
                                      clip_rewards=True, random_actions=random_actions)(
        player, pstate, carry, env_state_from_jax(pvenv.env, fresh), _t(draws), torch.tensor(expl))
    assert set(traj) == set(r_traj)
    flips = sum(_flag_flips(traj[k], r_traj[k], f"dreamer {k}") for k in ("dones", "is_first"))
    _cmp(traj["rgb"], r_traj["rgb"], "dreamer traj rgb", exact=True)
    # the actor's straight-through sample (one-hot + probs - probs) rounds
    # an ulp apart where the probs do: the values at 1e-5, the choices exactly
    _cmp(traj["actions"], r_traj["actions"], "dreamer traj actions")
    np.testing.assert_array_equal(traj["actions"].argmax(-1).numpy(), np.asarray(r_traj["actions"]).argmax(-1))
    _cmp(traj["rewards"], r_traj["rewards"], "dreamer traj rewards")  # tanh of the rewards
    for k, v in jax_flat(r_carry).items():
        node = carry
        for part in k.split("."):
            node = node[part] if isinstance(node, dict) else getattr(node, part)
        _cmp(node, v, f"dreamer carry {k}", exact=not k.endswith("prev_reward"))
    for k, v in jax_flat(r_pstate).items():
        _cmp(getattr(pstate, k), v, f"dreamer player state {k}")
    _cmp(ep["episodes"], r_ep["episodes"], "dreamer episodes", exact=True)
    for k in ("return_sum", "length_sum"):
        _cmp(ep[k], r_ep[k], f"dreamer ep {k}")
    assert flips == 0
    assert float(ep["episodes"]) > 0 and traj["is_first"][1:].sum() > 0  # auto-reset rows inside the chunk
    if random_actions:  # the player and its state are left untouched
        for k, v in jax_flat(jstate).items():
            np.testing.assert_array_equal(getattr(pstate, k).numpy(), np.asarray(v))
    else:  # the exploration's swaps were taken at 0.3
        assert (draws[..., -1] < expl).any()


# ---------------------------------------------------------------------------
# T steps against T single steps, bit for bit (port alone)
# ---------------------------------------------------------------------------


def test_ppo_collector_bit_exact_vs_step_by_step():
    from sheeprl_tpu_torch.envs.device.core import tree_index, tree_map
    from sheeprl_tpu_torch.envs.device.rollout import PPOCollectorCarry, make_ppo_collector

    rvenv, venv = _venvs("CartPole-v1", n=4)
    _, agent, actions_dim, cont = _ppo_agents(rvenv, venv)
    steps = 5
    gen = torch.Generator().manual_seed(3)
    fresh, noise = venv.draw_resets(gen, steps), agent.draw_noise(gen, steps, 4)
    carry_a = PPOCollectorCarry.reset(venv, torch.Generator().manual_seed(1))
    carry_b = PPOCollectorCarry.reset(venv, torch.Generator().manual_seed(1))
    traj, ep = make_ppo_collector(venv, steps, actions_dim, cont)(agent, carry_a, fresh, noise)
    one = make_ppo_collector(venv, 1, actions_dim, cont)
    rows = [one(agent, carry_b, tree_map(lambda x: x[t:t + 1], fresh), noise[t:t + 1])[0] for t in range(steps)]
    for k in traj:
        assert torch.equal(traj[k], torch.cat([r[k] for r in rows])), k
    assert all(torch.equal(a, b) for a, b in zip(_leaves(carry_a), _leaves(carry_b)))
    assert tree_index(fresh, 0).state.shape == (4, 4)


def _leaves(carry) -> list:
    """A carry's tensors in a fixed order (`tree_state_dict`)."""
    from sheeprl_tpu_torch.envs.device.core import tree_state_dict

    return [v for _, v in sorted(tree_state_dict(carry).items())]


def test_dreamer_ring_bit_exact_vs_step_by_step():
    """One T-step collector call written by `reserve`/`add_direct` leaves
    the same device ring (rows, heads, fullness) as T one-step calls."""
    from sheeprl_tpu_torch.data.buffers import AsyncReplayBuffer
    from sheeprl_tpu_torch.envs.device.core import tree_map
    from sheeprl_tpu_torch.envs.device.rollout import (
        DreamerCollectorCarry, make_dreamer_collector, random_action_sampler,
    )

    _, venv = _venvs("CartPole-v1", n=3)
    steps = 6
    kwargs = dict(actions_dim=(2,), is_continuous=False, preprocess=lambda o: o, random_actions=True)
    gen = torch.Generator().manual_seed(4)
    fresh = venv.draw_resets(gen, steps)
    actions = random_action_sampler(venv.single_action_space, (2,), False)(gen, steps, 3)

    def fresh_run():
        return DreamerCollectorCarry.reset(venv, torch.Generator().manual_seed(0)), AsyncReplayBuffer(
            16, 3, seed=7, storage="device", device="cpu")

    carry, rb_scan = fresh_run()
    idx = rb_scan.reserve(steps)
    traj, ep = make_dreamer_collector(venv, steps, **kwargs)(None, None, carry, fresh, actions, torch.tensor(0.0))
    rb_scan.add_direct(traj, idx, data_len=steps)
    carry_b, rb_ref = fresh_run()
    one = make_dreamer_collector(venv, 1, **kwargs)
    for t in range(steps):
        idx = rb_ref.reserve(1)
        row, _ = one(None, None, carry_b, tree_map(lambda x: x[t:t + 1], fresh), actions[t:t + 1], torch.tensor(0.0))
        rb_ref.add_direct(row, torch.from_numpy(idx), data_len=1)
    assert set(rb_scan._buf) == set(rb_ref._buf) == {"state", "actions", "rewards", "dones", "is_first"}
    for k in rb_scan._buf:
        assert torch.equal(rb_scan._buf[k], rb_ref._buf[k]), k
    np.testing.assert_array_equal(rb_scan._pos, rb_ref._pos)
    np.testing.assert_array_equal(rb_scan._full, rb_ref._full)
    assert rb_scan._buf["is_first"].shape == (16, 3, 1) and float(ep["episodes"]) >= 0
    assert all(torch.equal(a, b) for a, b in zip(_leaves(carry), _leaves(carry_b)))


# ---------------------------------------------------------------------------
# the device ring
# ---------------------------------------------------------------------------


def _ring_rows(rng, length: int, n: int) -> dict[str, np.ndarray]:
    return {"state": rng.normal(size=(length, n, 4)).astype(np.float32),
            "rgb": rng.integers(0, 256, (length, n, 8, 8, 3), dtype=np.uint8),
            "dones": (rng.random((length, n, 1)) < 0.2).astype(np.float32)}


def test_device_ring_matches_the_reference_ring_and_host_storage(tmp_path):
    from sheeprl_tpu.data import AsyncReplayBuffer as RefBuffer
    from sheeprl_tpu_torch.data.buffers import AsyncReplayBuffer

    n, size = 3, 10
    rng = np.random.default_rng(0)
    ref = RefBuffer(size, n, storage="device", sequential=True, obs_keys=("state",), seed=7)
    dev = AsyncReplayBuffer(size, n, seed=7, storage="device", device="cpu")
    host = AsyncReplayBuffer(size, n, seed=7)
    for length in (4, 3, 5, 2):  # wraps the ring
        chunk = _ring_rows(rng, length, n)
        r_idx, d_idx = ref.reserve(length), dev.reserve(length)
        np.testing.assert_array_equal(d_idx, r_idx)
        ref.add_direct({k: jnp.asarray(v) for k, v in chunk.items()}, jnp.asarray(r_idx), data_len=length)
        dev.add_direct({k: _t(v) for k, v in chunk.items()}, d_idx, data_len=length)
        host.add(chunk)
    for k, v in ref._store.items():
        np.testing.assert_array_equal(dev._buf[k].numpy(), np.asarray(v), err_msg=k)
        np.testing.assert_array_equal(host._buf[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(dev._pos, ref._upos)
    np.testing.assert_array_equal(dev._full, ref._ufull)
    np.testing.assert_array_equal(host._pos, ref._upos)
    # the same windows: injected, then drawn from the same generator
    env, start = rng.integers(0, n, 12), rng.integers(0, size, 12)
    got = dev.sample(4, sequence_length=3, n_samples=3, indices=(env, start))
    want = host.sample(4, sequence_length=3, n_samples=3, indices=(env, start))
    rows = (start[:, None] + np.arange(3)) % size
    for k, v in ref._store.items():
        manual = np.swapaxes(np.asarray(v)[rows, env[:, None]].reshape(3, 4, 3, *v.shape[2:]), 1, 2)
        np.testing.assert_array_equal(want[k], manual, err_msg=k)
        assert isinstance(got[k], torch.Tensor) and torch.equal(got[k], _t(want[k])), k
    drawn_dev, drawn_host = dev.sample(5, sequence_length=4, n_samples=2), host.sample(5, sequence_length=4,
                                                                                        n_samples=2)
    assert all(torch.equal(drawn_dev[k], _t(drawn_host[k])) for k in drawn_host)
    # save on one storage, load on the other: the same samples after
    dev.save(str(tmp_path / "dev.npz"))
    host.save(str(tmp_path / "host.npz"))
    from_dev, from_host = AsyncReplayBuffer(size, n), AsyncReplayBuffer(size, n, storage="device", device="cpu")
    from_dev.load(str(tmp_path / "dev.npz"))
    from_host.load(str(tmp_path / "host.npz"))
    a, b = from_dev.sample(6, sequence_length=2, n_samples=2), from_host.sample(6, sequence_length=2, n_samples=2)
    assert all(torch.equal(_t(a[k]), b[k]) for k in a)
    # reserve and add_direct are device storage's only
    with pytest.raises(RuntimeError):
        host.reserve(1)
    with pytest.raises(RuntimeError):
        host.add_direct({k: _t(v) for k, v in _ring_rows(rng, 1, n).items()}, np.zeros(2 * n, np.int32), 1)
    with pytest.raises(ValueError):
        idx = dev.reserve(2)
        dev.add_direct({k: _t(v) for k, v in _ring_rows(rng, 1, n).items()}, idx, 1)


# ---------------------------------------------------------------------------
# the mains
# ---------------------------------------------------------------------------


def _records(path) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


PPO_TINY = ["--device", "cpu", "--num_envs", "4", "--rollout_steps", "8", "--per_rank_batch_size", "8",
            "--update_epochs", "2", "--dense_units", "16", "--mlp_features_dim", "16", "--cnn_features_dim", "16",
            "--anneal_lr", "--ent_coef", "0.01"]


@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1", "pixeltoy"])
def test_ppo_jax_env_backend_dry_run(tmp_path, env_id):
    from sheeprl_tpu_torch.algos.ppo import ppo

    ppo.main([*PPO_TINY, "--dry_run", "--env_id", env_id, "--env_backend", "jax", "--root_dir", str(tmp_path),
              "--run_name", "r"])
    recs = _records(tmp_path / "r" / "metrics.jsonl")
    done, upd = recs[-1], [r for r in recs if "update" in r]
    assert len(upd) == 1 and all(np.isfinite(upd[0][k]) for k in ("Loss/policy_loss", "Loss/value_loss"))
    assert done["env_backend"] == "jax" and done["env_steps"] == 32 and len(done["test_returns"]) == 1
    assert done["anakin"]["Anakin/env_steps_total"] == 32 and done["anakin"]["Anakin/env_batch"] == 4
    assert set(done["compile_stats"]["entries"]) == {"anakin_rollout", "minibatch_step"}
    state = torch.load(tmp_path / "r" / "checkpoints" / "ckpt_1" / "state.pt", weights_only=False)
    assert {"agent", "optimizer", "update_step", "generator", "collector", "collector_generator"} <= set(state)
    assert state["collector"]["prev_done"].shape == (4, 1)


DV3_TINY = ["--device", "cpu", "--cnn_channels_multiplier", "2", "--dense_units", "16", "--hidden_size", "16",
            "--recurrent_state_size", "16", "--stochastic_size", "4", "--discrete_size", "4",
            "--per_rank_batch_size", "2", "--per_rank_sequence_length", "4", "--horizon", "3", "--buffer_size", "64",
            "--num_envs", "4", "--learning_starts", "16", "--total_steps", "48", "--train_every", "8",
            "--expl_amount", "0.3"]


@pytest.mark.parametrize("env_id", ["pixeltoy", "CartPole-v1"])
def test_dreamer_v3_jax_env_backend_trains_and_checkpoints(tmp_path, env_id):
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    dreamer_v3.main([*DV3_TINY, "--env_id", env_id, "--env_backend", "jax", "--root_dir", str(tmp_path),
                     "--run_name", "r"])
    done = _records(tmp_path / "r" / "metrics.jsonl")[-1]
    # chunks of train_every // num_envs = 2 steps: 2 random chunks, 4 of the player
    assert done["anakin_chunk"] == 2 and done["env_steps"] == 48 and done["player_steps"] == 8
    assert len(done["anakin_chunk_ms"]) == 4  # each player chunk's host wall
    assert done["gradient_steps"] == 1 + 4  # the pretrain step at the first chunk past learning_starts, then 1 a chunk
    assert set(done["compile_stats"]["entries"]) == {"train_step", "anakin_rollout", "anakin_rollout_random"}
    assert done["anakin"]["Anakin/rollouts"] == 6 and all(v > 0 for v in (done["Params/world_model_delta"],
                                                                          done["Params/actor_delta"]))
    assert [c["step"] for c in done["checkpoints"]] == [12] and len(done["test_returns"]) == 1
    ckpt = done["checkpoints"][0]["path"]
    assert os.path.exists(os.path.join(ckpt, "state.pt"))
    # the evaluation of that checkpoint plays on the host twin
    dreamer_v3.main(["--eval_only", "--checkpoint_path", ckpt, "--device", "cpu", "--test_episodes", "2",
                     "--root_dir", str(tmp_path), "--run_name", "e"])
    ev = _records(tmp_path / "e" / "metrics.jsonl")[-1]
    assert ev["gradient_steps"] == 0 and len(ev["test_returns"]) == 2


def test_dreamer_v3_jax_backend_refuses_continuous_actions(tmp_path):
    """The refusal is gone: continuous actions in DreamerV3 are ported, and
    the jax backend trains on Pendulum-v1 with float actions in its device
    ring (tests/test_torch_dv3_continuous.py holds its collector against
    the reference's)."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    dreamer_v3.main([*DV3_TINY, "--env_id", "Pendulum-v1", "--mlp_keys", "state", "--env_backend", "jax",
                     "--root_dir", str(tmp_path), "--run_name", "r"])
    done = _records(tmp_path / "r" / "metrics.jsonl")[-1]
    assert done["env_backend"] == "jax" and done["gradient_steps"] == 5 and done["player_steps"] == 8


def _use_static_plans(monkeypatch) -> None:
    from sheeprl_tpu_torch.compile import plan as plan_mod
    from sheeprl_tpu_torch.compile.plan import CompilePlan

    original = CompilePlan.from_args

    def from_args(args, telem=None):
        plan = original(args, telem)
        plan.mode, plan._backend = "static", plan_mod._StaticBuffers()
        return plan

    monkeypatch.setattr(CompilePlan, "from_args", staticmethod(from_args))


@pytest.mark.parametrize("warm", ["off", "on"])
def test_collectors_in_static_mode_equal_direct_calls(tmp_path, monkeypatch, warm):
    """The plan's copy machinery without graphs (`mode="static"`: adopted
    carry, draws copied into static inputs, outputs copied out) against the
    direct calls, through both CLIs: the same losses, returns and final
    parameters bit for bit."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3
    from sheeprl_tpu_torch.algos.ppo import ppo

    ppo_argv = [*PPO_TINY, "--total_steps", "96", "--env_id", "CartPole-v1", "--env_backend", "jax",
                "--root_dir", str(tmp_path)]
    dv3_argv = [*DV3_TINY, "--env_id", "pixeltoy", "--env_backend", "jax", "--root_dir", str(tmp_path)]
    ppo.main([*ppo_argv, "--run_name", "ppo_direct"])
    dreamer_v3.main([*dv3_argv, "--run_name", "dv3_direct"])
    _use_static_plans(monkeypatch)
    ppo.main([*ppo_argv, "--run_name", "ppo_static", "--warm_compile", warm])
    dreamer_v3.main([*dv3_argv, "--run_name", "dv3_static", "--warm_compile", warm])

    def rows(name, key):
        return [{k: v for k, v in r.items() if not k.startswith("Time/") and k != "sps"}
                for r in _records(tmp_path / name / "metrics.jsonl") if key in r]

    for algo, key in (("ppo", "update"), ("dv3", "Loss/policy_loss")):
        direct, static = rows(f"{algo}_direct", key), rows(f"{algo}_static", key)
        assert len(direct) >= 3 and static == direct, algo
        d, s = (_records(tmp_path / f"{algo}_{m}" / "metrics.jsonl")[-1] for m in ("direct", "static"))
        assert d["test_returns"] == s["test_returns"]
        entries = s["compile_stats"]["entries"]
        assert entries["anakin_rollout"]["compiled"] and entries["anakin_rollout"]["aot_calls"] > 0
        assert all(e["fallbacks"] == 0 for e in entries.values())
    sa = torch.load(tmp_path / "ppo_direct" / "checkpoints" / "ckpt_3" / "state.pt", weights_only=False)
    sb = torch.load(tmp_path / "ppo_static" / "checkpoints" / "ckpt_3" / "state.pt", weights_only=False)
    for part in ("agent", "collector"):
        assert all(torch.equal(sa[part][k], sb[part][k]) for k in sa[part]), part


def test_ppo_jax_resume_continues_the_rollout_stream_bit_for_bit(tmp_path):
    from sheeprl_tpu_torch.algos.ppo import ppo

    argv = [*PPO_TINY, "--total_steps", "64", "--env_id", "CartPole-v1", "--env_backend", "jax", "--root_dir",
            str(tmp_path), "--checkpoint_every", "1"]
    ppo.main([*argv, "--run_name", "full"])
    # a resume writes on in its checkpoint's run directory: resume a copy
    src, dst = tmp_path / "full" / "checkpoints", tmp_path / "resumed" / "checkpoints"
    shutil.copytree(src / "ckpt_1", dst / "ckpt_1")
    shutil.copy(src / "ckpt_1.args.json", dst / "ckpt_1.args.json")
    ppo.main(["--checkpoint_path", str(dst / "ckpt_1"), "--device", "cpu"])
    full = torch.load(tmp_path / "full" / "checkpoints" / "ckpt_2" / "state.pt", weights_only=False)
    resumed = torch.load(tmp_path / "resumed" / "checkpoints" / "ckpt_2" / "state.pt", weights_only=False)
    for part in ("agent", "collector"):
        assert set(full[part]) == set(resumed[part])
        assert all(torch.equal(full[part][k], resumed[part][k]) for k in full[part]), part
    for part in ("generator", "collector_generator"):
        assert torch.equal(full[part], resumed[part]), part
    a = [r for r in _records(tmp_path / "full" / "metrics.jsonl") if r.get("update") == 2]
    b = [r for r in _records(tmp_path / "resumed" / "metrics.jsonl") if r.get("update") == 2]
    keys = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss", "Rewards/rew_avg")
    assert [a[0].get(k) for k in keys] == [b[-1].get(k) for k in keys]


def test_env_backend_values_and_the_missing_twin(tmp_path):
    from sheeprl_tpu_torch.algos.ppo import ppo

    with pytest.raises(ValueError, match="env_backend must be 'host' or 'jax'"):
        ppo.main([*PPO_TINY, "--dry_run", "--env_backend", "gpu", "--root_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="no pure-JAX environment registered for 'discrete_dummy'"):
        ppo.main([*PPO_TINY, "--dry_run", "--env_id", "discrete_dummy", "--env_backend", "jax",
                  "--root_dir", str(tmp_path)])


def test_env_backend_host_is_the_default_bit_for_bit(tmp_path):
    from sheeprl_tpu_torch.algos.ppo import ppo

    argv = [*PPO_TINY, "--total_steps", "64", "--env_id", "CartPole-v1", "--root_dir", str(tmp_path)]
    ppo.main([*argv, "--run_name", "default"])
    ppo.main([*argv, "--run_name", "host", "--env_backend", "host"])
    a = torch.load(tmp_path / "default" / "checkpoints" / "ckpt_2" / "state.pt", weights_only=False)
    b = torch.load(tmp_path / "host" / "checkpoints" / "ckpt_2" / "state.pt", weights_only=False)
    assert "collector" not in a and all(torch.equal(a["agent"][k], b["agent"][k]) for k in a["agent"])
    ra, rb_ = (_records(tmp_path / n / "metrics.jsonl") for n in ("default", "host"))
    keys = ("Loss/policy_loss", "Loss/value_loss", "Rewards/rew_avg")
    assert [[r.get(k) for k in keys] for r in ra if "update" in r] == [[r.get(k) for k in keys] for r in rb_
                                                                       if "update" in r]


def test_anakin_gauges_are_the_reference_ones():
    from sheeprl_tpu.parallel.anakin import AnakinStats as RefStats
    from sheeprl_tpu_torch.parallel.anakin import AnakinStats

    ref, port = RefStats(scan_span=16, env_batch=8, devices=1), AnakinStats(scan_span=16, env_batch=8, devices=1)
    for stats in (ref, port):
        stats.note(128, 0.5)
        stats.note(128, 0.25)
    assert port.gauges() == ref.gauges() and port.env_steps_per_second == 512.0
