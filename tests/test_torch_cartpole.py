"""The port's CartPole-v1 (`envs/cartpole.py`) against the reference's
`JaxCartPole`, and the port's activation registry (`nn/core.py`) against
the reference's.

- CartPole: 300 steps from the same states with the same actions, the
  port's float32 numpy arithmetic against the reference's jitted float32
  JAX step: observations at atol 1e-5 (the same float32 operations in the
  same order; `cos`/`sin` of two libraries may differ by an ulp, and the
  states stay below 5 in magnitude between resets), `terminated` and
  `truncated` equal at every step. After each end of episode both restart
  from one shared state drawn uniform in +-0.05; the first episode starts
  20 steps before the 500-step truncation.
- Activations: every name in the reference's `_ACTIVATIONS`, on the same
  float32 inputs in [-6, 6], at atol 1e-6, and the two registries holding
  the same names. GELU is the tanh form (`jax.nn.gelu`'s default,
  `approximate=True`): the exact erf form differs from it by up to 4.7e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.envs.jax.cartpole import CartPoleState, JaxCartPole
from sheeprl_tpu.nn import core as jcore
from sheeprl_tpu_torch.envs.cartpole import CartPole
from sheeprl_tpu_torch.nn import core as tcore


def test_cartpole_matches_the_jax_cartpole():
    ref = JaxCartPole()
    ref_step = jax.jit(ref.step)
    port = CartPole(seed=0)
    rng = np.random.default_rng(0)
    start = rng.uniform(-0.05, 0.05, 4).astype(np.float32)
    t0 = port.max_episode_steps - 20
    jstate = CartPoleState(state=jnp.asarray(start), t=jnp.asarray(t0, jnp.int32))
    port.state, port.t = start.copy(), t0
    key = jax.random.PRNGKey(0)
    ends = {"terminated": 0, "truncated": 0}
    for i in range(300):
        s = port.state
        if i < 20:  # balance: push toward the side the pole falls to
            action = int(s[2] + 0.5 * s[3] > 0)
        else:
            action = int(rng.integers(0, 2))
        jstate, jobs, jrew, jterm, jtrunc = ref_step(jstate, jnp.asarray(action), key)
        obs, rew, term, trunc, _ = port.step(action)
        assert obs.dtype == np.float32 and obs.shape == (4,)
        np.testing.assert_allclose(obs, np.asarray(jobs["state"]), atol=1e-5, rtol=0, err_msg=f"step {i}")
        assert rew == float(jrew) == 1.0
        assert (term, trunc) == (bool(jterm), bool(jtrunc)), f"step {i}"
        if term or trunc:
            ends["terminated" if term else "truncated"] += 1
            start = rng.uniform(-0.05, 0.05, 4).astype(np.float32)
            jstate = CartPoleState(state=jnp.asarray(start), t=jnp.asarray(0, jnp.int32))
            port.state, port.t = start.copy(), 0
    assert ends["truncated"] == 1 and ends["terminated"] >= 5, ends


def test_cartpole_spaces_and_reset_follow_the_reference():
    ref, port = JaxCartPole(), CartPole(seed=3)
    np.testing.assert_array_equal(port.observation_space.high, ref.observation_space["state"].high)
    np.testing.assert_array_equal(port.observation_space.low, ref.observation_space["state"].low)
    assert port.action_space.n == ref.action_space.n == 2
    first, _ = port.reset(seed=11)
    again, _ = CartPole(seed=0).reset(seed=11)
    np.testing.assert_array_equal(first, again)  # the seed decides the start
    starts = np.stack([port.reset()[0] for _ in range(200)])
    assert starts.dtype == np.float32 and float(np.abs(starts).max()) <= 0.05
    assert port.t == 0


def test_make_dict_env_routes_cartpole_under_the_mlp_key():
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.utils.env import make_dict_env

    args = DreamerV3Args(env_id="CartPole-v1")
    args.cnn_keys, args.mlp_keys = [], ["state"]
    env = make_dict_env("CartPole-v1", 5, rank=0, args=args)()
    assert list(env.observation_space.spaces) == ["state"]
    obs, _ = env.reset(seed=5)
    assert set(obs) == {"state"} and obs["state"].shape == (4,)
    obs2, reward, term, trunc, _ = env.step(1)
    assert set(obs2) == {"state"} and reward == 1.0 and not term and not trunc
    args.mlp_keys = []  # no key given: the first mlp key becomes `state`
    make_dict_env("cartpole-v1", 0, rank=0, args=args)()
    assert args.mlp_keys == ["state"]


def test_activation_registries_hold_the_same_names():
    assert set(tcore._ACTIVATIONS) == set(jcore._ACTIVATIONS)


@pytest.mark.parametrize("name", sorted(jcore._ACTIVATIONS))
def test_activation_matches_the_reference(name):
    x = np.concatenate([np.linspace(-6.0, 6.0, 1201), np.random.default_rng(0).normal(0, 2, 500)])
    x = x.astype(np.float32)
    want = np.asarray(jcore.activation(name)(jnp.asarray(x)))
    got = tcore.activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)
