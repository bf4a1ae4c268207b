"""PPO in the port (`algos/ppo/`, `ops/math.py:gae`/`normalize`,
`ops/distributions.py:Normal`, `nn/blocks.py:NatureCNN`,
`data/buffers.py:ReplayBuffer`, `interop.ppo_agent_from_jax` /
`ppo_checkpoint_from_jax`) against the reference `sheeprl_tpu` on the CPU,
at small sizes, with inputs made from seeds by numpy:

  - `gae` (dones at step 0, mid-rollout and at the bootstrap) and
    `normalize` (plain and masked): atol 1e-6;
  - the three losses, every reduction, `clip_vloss` both ways: 1e-6;
  - `Normal` / `Independent` log-prob and entropy: 1e-6;
  - `NatureCNN` at 64 x 64 x 3: rtol 1e-5;
  - `PPOAgent` with the reference's parameters on CartPole-v1,
    multidiscrete_dummy, continuous_dummy and discrete_dummy pixels: the
    log-prob, entropy and value of the reference's sampled actions at rtol
    1e-5 in f32 (atol 1e-5 for values near 0) and rtol 3e-2 / atol 3e-3 in
    bf16 (a few bf16 roundings on each path); greedy actions equal in f32;
  - one whole update against the reference's `make_train_step` (dense 16,
    a rollout of 8 steps x 2 envs, minibatch 4, 2 epochs, the reference's
    permutations injected; `max_grad_norm` 0 and 0.5, advantages
    normalized or not): parameters and Adam moments at rtol 1e-5 / atol
    1e-6 after 8 Adam steps, the three losses at rtol 1e-5;
  - `ppo --device cpu --dry_run` on the four envs: finite losses, the
    checkpoint's keys and sidecar, a resume at `update_step + 1` whose
    state equals the file bit for bit, `--eval_only` over it;
  - a reference PPO checkpoint (its `ppo` main, `--dry_run`, CartPole)
    carried by `ppo_checkpoint_from_jax`: parameters and Adam moments bit
    for bit, greedy actions on 64 seeded observations equal.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_interop import jax_flat

T, N = 8, 2  # the rollout of the update's parity test


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# math, losses, distributions
# ---------------------------------------------------------------------------

# (dones [T, N], next_done [N]): none, at step 0, mid-rollout, at the bootstrap, all of them
DONE_CASES = {
    "none": ([], []),
    "step0": ([(0, 0), (0, 1)], []),
    "mid": ([(3, 0), (5, 1), (6, 1)], []),
    "bootstrap": ([], [1]),
    "everywhere": ([(0, 1), (4, 0), (7, 1)], [0, 1]),
}


@pytest.mark.parametrize("case", sorted(DONE_CASES))
def test_gae_matches_the_reference(case):
    from sheeprl_tpu.ops.math import gae as ref_gae
    from sheeprl_tpu_torch.ops.math import gae

    rng = np.random.default_rng(3)
    rewards = rng.normal(size=(T, N, 1)).astype(np.float32)
    values = rng.normal(size=(T, N, 1)).astype(np.float32)
    next_value = rng.normal(size=(N, 1)).astype(np.float32)
    dones, next_done = np.zeros((T, N, 1), np.float32), np.zeros((N, 1), np.float32)
    for t, n in DONE_CASES[case][0]:
        dones[t, n] = 1.0
    for n in DONE_CASES[case][1]:
        next_done[n] = 1.0
    want = ref_gae(*(jnp.asarray(a) for a in (rewards, values, dones, next_value, next_done)), 0.99, 0.95)
    got = gae(*(_t(a) for a in (rewards, values, dones, next_value, next_done)), 0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_normalize_matches_the_reference(masked):
    from sheeprl_tpu.ops.math import normalize as ref_normalize
    from sheeprl_tpu_torch.ops.math import normalize

    rng = np.random.default_rng(4)
    x = (rng.normal(size=(64, 1)) * 3 + 1).astype(np.float32)
    mask = (rng.random((64, 1)) > 0.3).astype(np.float32) if masked else None
    want = ref_normalize(jnp.asarray(x), mask=None if mask is None else jnp.asarray(mask))
    got = normalize(_t(x), mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("clip_vloss", [False, True])
def test_losses_match_the_reference(reduction, clip_vloss):
    from sheeprl_tpu.algos.ppo import loss as ref
    from sheeprl_tpu_torch.algos.ppo import loss

    rng = np.random.default_rng(5)
    new_lp, old_lp, adv, new_v, old_v, ret, ent = (rng.normal(size=(32, 1)).astype(np.float32) for _ in range(7))
    pairs = [
        (loss.policy_loss(_t(new_lp), _t(old_lp), _t(adv), 0.2, reduction),
         ref.policy_loss(jnp.asarray(new_lp), jnp.asarray(old_lp), jnp.asarray(adv), 0.2, reduction)),
        (loss.value_loss(_t(new_v), _t(old_v), _t(ret), 0.2, clip_vloss, reduction),
         ref.value_loss(jnp.asarray(new_v), jnp.asarray(old_v), jnp.asarray(ret), 0.2, clip_vloss, reduction)),
        (loss.entropy_loss(_t(ent), reduction), ref.entropy_loss(jnp.asarray(ent), reduction)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_normal_and_independent_match_the_reference():
    from sheeprl_tpu.ops import distributions as ref
    from sheeprl_tpu_torch.ops.distributions import Independent, Normal

    rng = np.random.default_rng(6)
    loc, x = rng.normal(size=(2, 16, 3)).astype(np.float32)
    scale = np.exp(rng.normal(size=(16, 3)) * 0.5).astype(np.float32)
    r_normal = ref.Normal(loc=jnp.asarray(loc), scale=jnp.asarray(scale))
    normal = Normal(_t(loc), _t(scale))
    r_ind, ind = ref.Independent(base=r_normal, event_ndims=1), Independent(normal, 1)
    for got, want in ((normal.log_prob(_t(x)), r_normal.log_prob(jnp.asarray(x))),
                      (normal.entropy(), r_normal.entropy()),
                      (ind.log_prob(_t(x)), r_ind.log_prob(jnp.asarray(x))), (ind.entropy(), r_ind.entropy())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    draw = ind.sample(torch.Generator().manual_seed(0), (4,))
    assert draw.shape == (4, 16, 3) and torch.isfinite(draw).all()
    assert torch.equal(ind.sample(torch.Generator().manual_seed(0), (4,)), draw)


def test_nature_cnn_matches_the_reference():
    from sheeprl_tpu.nn import NatureCNN as RefNatureCNN
    from sheeprl_tpu_torch.interop import load_jax_params
    from sheeprl_tpu_torch.nn import NatureCNN

    ref = RefNatureCNN.init(jax.random.PRNGKey(0), 3, 64, screen_size=64)
    port = load_jax_params(NatureCNN(3, 64, screen_size=64), jax_flat(ref))
    x = np.random.default_rng(7).random((5, 64, 64, 3)).astype(np.float32)
    want = np.asarray(ref(jnp.asarray(x)))
    got = port(_t(x)).detach().numpy()
    assert got.shape == (5, 64) and port.fc.in_features == 4 * 4 * 64
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_replay_buffer_ring_and_sampling():
    """The rollout ring: rows written at one head for all envs, wrapping;
    a rollout of exactly `buffer_size` rows reads back in order; uniform
    samples come from written rows only, on either storage."""
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer

    for storage in ("device", "host"):
        rb = ReplayBuffer(4, 2, storage=storage, device="cpu", obs_keys=("obs",), seed=0)
        for t in range(6):
            rb.add({"obs": np.full((1, 2, 3), t, np.float32), "dones": torch.full((1, 2, 1), float(t))})
        rows = np.asarray(rb["obs"])[:, 0, 0]
        assert rows.tolist() == [4.0, 5.0, 2.0, 3.0] and rb.full and rb.pos == 2
        rb.add({"obs": np.arange(8, dtype=np.float32).reshape(4, 2, 1).repeat(3, -1),
                "dones": np.zeros((4, 2, 1), np.float32)})
        assert np.asarray(rb["obs"])[:, 1, 0].tolist() == [5.0, 7.0, 1.0, 3.0]
        batch = rb.sample(16, sample_next_obs=True)
        assert batch["obs"].shape == (16, 3) and batch["next_obs"].shape == (16, 3)
    fresh = ReplayBuffer(4, 1, storage="host", seed=0)
    fresh.add({"obs": np.ones((1, 1, 1), np.float32)})
    assert np.asarray(fresh.sample(8)["obs"]).tolist() == [[1.0]] * 8
    with pytest.raises(RuntimeError):
        fresh.sample(1, sample_next_obs=True)


@pytest.mark.parametrize("env", ["multidiscrete", "continuous"])
def test_rollout_fills_host_and_device_storage_alike(env):
    """`Rollout.collect` into a device ring and into a host ring (the one-hot
    rebuilt from the pulled indices, host obs) from the same envs, agent and
    generator seed: the same rows, and each `dones` row is the done flag
    entering its step (the dummy envs end every fifth step)."""
    from sheeprl_tpu_torch.algos.ppo.ppo import Rollout
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.envs.vector import SyncVectorEnv
    from sheeprl_tpu_torch.utils.env import make_dict_env

    _, agent = _agents(env)
    keys = ["rgb"]
    rows = []
    for storage in ("device", "host"):
        args = type("A", (), {"cnn_keys": keys, "mlp_keys": None, "screen_size": 64})()
        envs = SyncVectorEnv([make_dict_env(ENVS[env]["env_id"], i, 0, args) for i in range(2)])
        rb = ReplayBuffer(12, 2, storage=storage, device="cpu", obs_keys=keys)
        rollout = Rollout(envs, 0)
        rollout.collect(agent, rb, keys, torch.Generator().manual_seed(4))
        rows.append({k: np.asarray(rb[k]) for k in (*keys, "actions", "logprobs", "values", "rewards", "dones")})
        assert [e[1] for e in rollout.ended] == [5, 5, 5, 5]
    for k in rows[0]:
        np.testing.assert_array_equal(rows[0][k], rows[1][k], err_msg=k)
    assert rows[0]["dones"][:, :, 0].T.tolist() == [[0.0] * 5 + [1.0] + [0.0] * 4 + [1.0, 0.0]] * 2


# ---------------------------------------------------------------------------
# the agent
# ---------------------------------------------------------------------------

ENVS = {
    "cartpole": dict(env_id="CartPole-v1", cnn=[], mlp=["state"]),
    "multidiscrete": dict(env_id="multidiscrete_dummy", cnn=["rgb"], mlp=[]),
    "continuous": dict(env_id="continuous_dummy", cnn=["rgb"], mlp=[]),
    "pixels": dict(env_id="discrete_dummy", cnn=["rgb"], mlp=[]),
}
AGENT_KW = dict(cnn_features_dim=32, mlp_features_dim=16, mlp_layers=2, dense_units=16, dense_act="tanh")


def _spaces(env: str):
    """(reference gym spaces, port spaces, actions_dim, is_continuous)."""
    import gymnasium as gym

    from sheeprl_tpu_torch.envs import spaces

    if env == "cartpole":
        return ({"state": gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)},
                {"state": spaces.Box(-np.inf, np.inf, (4,))}, [2], False)
    ref = {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)}
    port = {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}
    return ref, port, {"multidiscrete": [2, 2], "continuous": [2], "pixels": [2]}[env], env == "continuous"


def _agents(env: str, precision: str = "float32", seed: int = 0, **kw):
    """The reference's PPOAgent and the port's, its parameters carried
    across by `interop.ppo_agent_from_jax`."""
    from sheeprl_tpu.algos.ppo.agent import PPOAgent as RefAgent
    from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent
    from sheeprl_tpu_torch.interop import ppo_agent_from_jax

    ref_space, port_space, actions_dim, cont = _spaces(env)
    cnn, mlp = ENVS[env]["cnn"], ENVS[env]["mlp"]
    opts = {**AGENT_KW, **kw, "is_continuous": cont, "precision": precision}
    ref = RefAgent.init(jax.random.PRNGKey(seed), actions_dim, ref_space, cnn, mlp, **opts)
    port = ppo_agent_from_jax(PPOAgent(actions_dim, port_space, cnn, mlp, **opts), jax_flat(ref))
    return ref, port


def _obs(env: str, n: int, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    if env == "cartpole":
        return {"state": (rng.normal(size=(n, 4)) * [1.0, 1.0, 0.1, 1.0]).astype(np.float32)}
    return {"rgb": rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)}


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("env", sorted(ENVS))
def test_agent_matches_the_reference(env, precision):
    ref, port = _agents(env, precision)
    obs = _obs(env, 16)
    actions, r_lp, r_ent, r_val = ref({k: jnp.asarray(v) for k, v in obs.items()}, key=jax.random.PRNGKey(1))
    with torch.no_grad():
        got_actions, lp, ent, val = port({k: _t(v) for k, v in obs.items()}, actions=_t(actions))
    assert torch.equal(got_actions, _t(actions))
    rtol, atol = (1e-5, 1e-5) if precision == "float32" else (3e-2, 3e-3)
    for got, want in ((lp, r_lp), (ent, r_ent), (val, r_val)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
    if precision == "float32":
        greedy = np.asarray(ref.get_greedy_actions({k: jnp.asarray(v) for k, v in obs.items()}))
        with torch.no_grad():
            got = port.get_greedy_actions({k: _t(v) for k, v in obs.items()}).numpy()
        if port.is_continuous:
            np.testing.assert_allclose(got, greedy, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, greedy)


def test_sampling_takes_its_noise():
    """A sample is its noise's: the same generator seed draws the same
    actions, one-hot a head by Gumbel-max over the logits (continuous: mean
    + std * noise), and `env_action_indices` pulls each head's argmax;
    sampling without noise raises."""
    from sheeprl_tpu_torch.algos.ppo.agent import env_action_indices, indices_to_env_actions, one_hot_to_env_actions

    for env in ("multidiscrete", "continuous"):
        _, port = _agents(env)
        obs = {k: _t(v) for k, v in _obs(env, 8).items()}
        noise = port.draw_noise(torch.Generator().manual_seed(3), 8)
        assert noise.shape == (8, sum(port.actions_dim))
        with torch.no_grad():
            a1 = port(obs, noise=noise)[0]
            a2 = port(obs, noise=port.draw_noise(torch.Generator().manual_seed(3), 8))[0]
            pre = port._pre_dist(port.features(obs))
        assert torch.equal(a1, a2) and torch.isfinite(a1).all()
        if port.is_continuous:
            mean, log_std = torch.chunk(pre[0], 2, dim=-1)
            torch.testing.assert_close(a1, mean + log_std.exp() * noise)
        else:
            want = [torch.nn.functional.one_hot((lg + g).argmax(-1), lg.shape[-1]).float()
                    for lg, g in zip(pre, torch.split(noise, list(port.actions_dim), dim=-1))]
            assert torch.equal(a1, torch.cat(want, dim=-1))
        with pytest.raises(ValueError, match="noise"):
            port(obs)
        idx = env_action_indices(a1, port.actions_dim, port.is_continuous)
        want = one_hot_to_env_actions(a1, port.actions_dim, port.is_continuous)
        np.testing.assert_array_equal(indices_to_env_actions(idx.numpy(), port.actions_dim, port.is_continuous), want)
        if not port.is_continuous:
            assert a1.sum(-1).tolist() == [2.0] * 8 and idx.dtype == torch.int32


# ---------------------------------------------------------------------------
# one update against the reference's make_train_step
# ---------------------------------------------------------------------------


def _update_args(max_grad_norm: float, normalize: bool):
    from sheeprl_tpu.algos.ppo.args import PPOArgs as RefArgs
    from sheeprl_tpu_torch.algos.ppo.args import PPOArgs

    kw = dict(rollout_steps=T, num_envs=N, per_rank_batch_size=4, update_epochs=2, dense_units=16,
              max_grad_norm=max_grad_norm, normalize_advantages=normalize, ent_coef=0.01, lr=3e-3,
              mlp_features_dim=16, cnn_keys=[], mlp_keys=["state"])
    return RefArgs(**kw), PPOArgs(**kw, device="cpu")


def _rollout(seed: int = 11) -> dict[str, np.ndarray]:
    """A flat rollout of T * N rows with the reference agent's own shapes."""
    rng = np.random.default_rng(seed)
    n = T * N
    return {
        "state": (rng.normal(size=(n, 4)) * [1.0, 1.0, 0.1, 1.0]).astype(np.float32),
        "actions": np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)],
        "logprobs": np.log(rng.uniform(0.3, 0.7, (n, 1))).astype(np.float32),
        "values": rng.normal(size=(n, 1)).astype(np.float32),
        "returns": rng.normal(size=(n, 1)).astype(np.float32) * 3,
        "advantages": rng.normal(size=(n, 1)).astype(np.float32) * 2,
    }


def _reference_permutations(key, epochs: int, n: int) -> np.ndarray:
    """The permutations the reference's update draws from `key`
    (`ppo.py:177-183`)."""
    return np.stack([np.asarray(jax.random.permutation(k, n)) for k in jax.random.split(key, epochs)])


def _adam_of(opt_state) -> dict:
    """The reference's live optax state -> {count, mu, nu} with flat paths."""
    state = next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                 if hasattr(s, "mu"))
    return {"count": np.asarray(state.count), "mu": jax_flat(state.mu), "nu": jax_flat(state.nu)}


@pytest.mark.parametrize("normalize", [False, True], ids=["raw_adv", "normalized_adv"])
@pytest.mark.parametrize("max_grad_norm", [0.0, 0.5])
def test_one_update_matches_the_reference(max_grad_norm, normalize):
    from sheeprl_tpu.algos.ppo.ppo import TrainState
    from sheeprl_tpu.algos.ppo.ppo import make_optimizer as ref_optimizer
    from sheeprl_tpu.algos.ppo.ppo import make_train_step as ref_step
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step
    from sheeprl_tpu_torch.interop import adam_state_from_jax, flatten_params
    from sheeprl_tpu_torch.nn.layers import Linear

    ref_args, args = _update_args(max_grad_norm, normalize)
    ref_agent, agent = _agents("cartpole", mlp_features_dim=16)
    num_minibatches = T * N // args.per_rank_batch_size
    data = _rollout()
    key = jax.random.PRNGKey(2)
    lr, clip_coef, ent_coef = 3e-3, 0.2, 0.01

    optax_opt = ref_optimizer(ref_args)
    state, ref_metrics = ref_step(ref_args, optax_opt, num_minibatches)(
        TrainState(agent=ref_agent, opt_state=optax_opt.init(ref_agent)), {k: jnp.asarray(v) for k, v in data.items()},
        key, jnp.float32(lr), jnp.float32(clip_coef), jnp.float32(ent_coef))
    optimizer = make_optimizer(args, agent)
    metrics = make_train_step(args, num_minibatches)(
        agent, optimizer, {k: _t(v) for k, v in data.items()}, lr, clip_coef, ent_coef,
        perms=_t(_reference_permutations(key, args.update_epochs, T * N)))

    for k, v in metrics.items():
        np.testing.assert_allclose(v, float(ref_metrics[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    linear = {f"{n}.weight" for n, m in agent.named_modules() if isinstance(m, Linear)}
    want_params = flatten_params(jax_flat(state.agent))
    params = dict(agent.named_parameters())
    assert set(params) == set(want_params)
    for name, p in params.items():
        want = want_params[name].T if name in linear else want_params[name]
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5, atol=1e-6, err_msg=name)
    # the Adam moments, laid out as the port's, and the step counts
    want_opt = adam_state_from_jax(agent, optimizer, _adam_of(state.opt_state))
    got_opt = optimizer.state_dict()
    for i, st in want_opt["state"].items():
        assert float(got_opt["state"][i]["step"]) == float(st["step"]) == args.update_epochs * num_minibatches
        for side in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got_opt["state"][i][side].numpy(), st[side].numpy(), rtol=1e-5, atol=1e-6)


def test_update_drops_the_remainder_of_each_permutation():
    """With `n % num_minibatches != 0` each epoch takes the first
    `num_minibatches * (n // num_minibatches)` rows of its permutation: rows
    past them contribute nothing."""
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step

    _, args = _update_args(0.0, False)
    data = {k: _t(v) for k, v in _rollout().items()}
    perms = torch.stack([torch.arange(T * N)] * args.update_epochs)
    results = []
    for poison in (False, True):
        _, agent = _agents("cartpole", mlp_features_dim=16)
        batch = {k: v.clone() for k, v in data.items()}
        if poison:  # the last row is never drawn with 3 minibatches of 5 from 16 rows
            batch["advantages"][-1] = float("nan")
        make_train_step(args, 3)(agent, make_optimizer(args, agent), batch, 1e-3, 0.2, 0.0, perms=perms)
        results.append([p.detach().clone() for p in agent.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*results))


# ---------------------------------------------------------------------------
# the port's main
# ---------------------------------------------------------------------------

TINY_PPO = ["--device", "cpu", "--num_envs", "2", "--rollout_steps", "8", "--per_rank_batch_size", "4",
            "--update_epochs", "2", "--dense_units", "16", "--cnn_features_dim", "32", "--mlp_features_dim", "16"]


def _records(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("env", sorted(ENVS))
def test_main_dry_run_checkpoint_resume_and_eval(env, tmp_path, monkeypatch):
    from sheeprl_tpu_torch.algos.ppo import ppo
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, valid_checkpoint

    run_dir = str(tmp_path / "r")
    argv = [*TINY_PPO, "--env_id", ENVS[env]["env_id"], "--dry_run", "--root_dir", str(tmp_path), "--run_name", "r"]
    if ENVS[env]["cnn"]:
        argv += ["--cnn_keys", *ENVS[env]["cnn"]]
    ppo.main(argv)
    ckpt1 = os.path.join(run_dir, "checkpoints", "ckpt_1")
    assert valid_checkpoint(ckpt1)[0]
    saved = load_checkpoint(ckpt1)
    assert set(saved) == {"agent", "optimizer", "update_step", "generator"} and saved["update_step"] == 1
    with open(ckpt1 + ".args.json") as fh:
        assert json.load(fh)["env_id"] == ENVS[env]["env_id"]
    records = _records(run_dir)
    updates = [r for r in records if "update" in r]
    assert len(updates) == 1 and all(np.isfinite(updates[0][k]) for k in ppo.LOSSES)
    assert records[-1]["event"] == "done" and len(records[-1]["test_returns"]) == 1

    # the resume: at update 2, from exactly the file's state
    seen = {}
    real = ppo.make_train_step

    def spy(*a, **k):
        step = real(*a, **k)

        def recorded(agent, optimizer, *args, **kwargs):
            seen.setdefault("agent", {n: p.detach().clone() for n, p in agent.state_dict().items()})
            seen.setdefault("optimizer", {i: {k: v.clone() for k, v in st.items()}
                                          for i, st in optimizer.state_dict()["state"].items()})
            return step(agent, optimizer, *args, **kwargs)

        return recorded

    monkeypatch.setattr(ppo, "make_train_step", spy)
    ppo.main(["--checkpoint_path", ckpt1])
    monkeypatch.undo()
    for name, p in seen["agent"].items():
        assert torch.equal(p, saved["agent"][name]), name
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(seen["optimizer"][i][k], v), (i, k)
    done = _records(run_dir)[-1]
    assert done["resumed"]["start_update"] == 2 and done["updates"] == 1
    assert [c["update"] for c in done["checkpoints"]] == [2]

    ppo.main(["--eval_only", "--checkpoint_path", os.path.join(run_dir, "checkpoints", "ckpt_2"), "--test_episodes",
              "2", "--device", "cpu", "--root_dir", str(tmp_path), "--run_name", "eval"])
    records = _records(str(tmp_path / "eval"))
    assert records[-1]["updates"] == 0 and len(records[-1]["test_returns"]) == 2
    assert [k for r in records[:-1] for k in r if k.startswith("Test/")] == [
        "Test/cumulative_reward", "Test/episode_reward"] * 2 + ["Test/mean_reward"]


@pytest.mark.timeout(300)
def test_reference_checkpoint_carries_across(tmp_path):
    """The reference's `ppo` main writes a CartPole checkpoint; the port's
    Adam state and parameters from `ppo_checkpoint_from_jax` are its own
    bit for bit, and the port's main evaluates it; greedy actions agree on
    64 seeded observations."""
    from sheeprl_tpu.algos.ppo.agent import PPOAgent as RefAgent
    from sheeprl_tpu.algos.ppo.args import PPOArgs as RefArgs
    from sheeprl_tpu.algos.ppo.ppo import main as ref_main
    from sheeprl_tpu.algos.ppo.ppo import make_optimizer as ref_optimizer
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu_torch.algos.ppo import ppo
    from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent
    from sheeprl_tpu_torch.interop import flatten_params, ppo_checkpoint_from_jax
    from sheeprl_tpu_torch.nn.layers import Linear
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

    ref_main(["--env_id", "CartPole-v1", "--dry_run", "--num_devices", "1", "--num_envs", "2", "--sync_env",
              "--rollout_steps", "8", "--per_rank_batch_size", "4", "--update_epochs", "2", "--dense_units", "16",
              "--max_grad_norm", "0.5", "--root_dir", str(tmp_path), "--run_name", "ref"])
    ref_ckpt = str(tmp_path / "ref" / "checkpoints" / "ckpt_1")
    raw = ref_load(ref_ckpt)
    ref_space, port_space, _, _ = _spaces("cartpole")
    kw = dict(mlp_layers=2, dense_units=16, dense_act="tanh")
    template = RefAgent.init(jax.random.PRNGKey(0), [2], ref_space, [], ["state"], **kw)
    tree = ref_load(ref_ckpt, {"agent": template, "optimizer": ref_optimizer(RefArgs(max_grad_norm=0.5)).init(template),
                               "update_step": 0})
    agent = PPOAgent([2], port_space, [], ["state"], **kw)
    optimizer = torch.optim.Adam(agent.parameters(), eps=1e-4)
    converted = ppo_checkpoint_from_jax(raw, agent, optimizer)
    agent.load_state_dict(converted["agent"])
    optimizer.load_state_dict(converted["optimizer"])

    linear = {f"{n}.weight" for n, m in agent.named_modules() if isinstance(m, Linear)}
    adam = next(s for s in raw["optimizer"] if isinstance(s, dict) and "mu" in s)  # [clip's None, Adam]
    mu, nu, want_params = flatten_params(adam["mu"]), flatten_params(adam["nu"]), flatten_params(raw["agent"])
    params = dict(agent.named_parameters())
    for name, p in params.items():
        tr = (lambda a: a.T) if name in linear else (lambda a: a)
        np.testing.assert_array_equal(p.detach().numpy(), tr(want_params[name]), err_msg=name)
        st = optimizer.state[p]
        assert float(st["step"]) == float(adam["count"]) == 2 * 4  # 2 epochs of 16 // 4 minibatches
        np.testing.assert_array_equal(st["exp_avg"].numpy(), tr(mu[name]), err_msg=name)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), tr(nu[name]), err_msg=name)
    assert converted["update_step"] == 1

    obs = _obs("cartpole", 64, seed=9)
    want = np.asarray(tree["agent"].get_greedy_actions({"state": jnp.asarray(obs["state"])}))
    with torch.no_grad():
        got = agent.get_greedy_actions({"state": _t(obs["state"])}).numpy()
    np.testing.assert_array_equal(got, want)

    # the converted checkpoint in the port's format, evaluated by its main
    port_ckpt = str(tmp_path / "port" / "checkpoints" / "ckpt_1")
    sidecar = json.load(open(ref_ckpt + ".args.json"))
    save_checkpoint(port_ckpt, converted, {**sidecar, "device": "cpu"})
    ppo.main(["--eval_only", "--checkpoint_path", port_ckpt, "--device", "cpu", "--root_dir", str(tmp_path),
              "--run_name", "eval"])
    assert _records(str(tmp_path / "eval"))[-1]["updates"] == 0


def test_ppo_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would be used")
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["ppo", "--env_id", "CartPole-v1"])
