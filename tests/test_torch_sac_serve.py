"""SAC serving with `--quant int8` in the port, against the JAX package, on
the CPU at small widths (hidden 32): the Pendulum env, the SAC actor, the
fused int8 step, per-rung acceptance under the quality receipt, the reload
hook, and `serve --algo sac --quant int8` end to end.

Tolerances: Pendulum's f32 dynamics 1e-5 (the two libm's sin/cos may be an
ulp apart, and 200 steps carry it); the actor rtol 1e-5 (f32 sums in
another order); the fused step atol 1e-6 (the integer trunk is exact, the
f32 dequant may fuse into an FMA on the reference's side); served answers
exactly (the same computation as the direct call)."""

from __future__ import annotations

import json
import os
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_kernels as pk
from sheeprl_tpu_torch.ops import quant as tq
from tests.test_torch_int8 import ACT_DIM, HIDDEN, OBS_DIM, quantized_actors, sac_actors

SAC_MODEL = f"--actor_hidden_size {HIDDEN}"


@pytest.fixture
def pallas_interpret():
    pk.set_pallas(True, interpret=True)
    yield
    pk.set_pallas(None, interpret=False)


# ---------------------------------------------------------------------------
# Pendulum-v1
# ---------------------------------------------------------------------------


def test_pendulum_matches_the_jax_pendulum_over_an_episode():
    from sheeprl_tpu.envs.jax.pendulum import JaxPendulum, PendulumState
    from sheeprl_tpu_torch.envs.pendulum import Pendulum

    env = Pendulum(seed=3)
    obs, _ = env.reset()
    jenv = JaxPendulum()
    jstate = PendulumState(state=jnp.asarray(env.state), t=jnp.zeros((), jnp.int32))
    np.testing.assert_allclose(obs, np.asarray(jenv._obs(jstate.state)), atol=1e-6)
    actions = np.random.default_rng(0).uniform(-3.0, 3.0, (200, 1)).astype(np.float32)  # some clip
    key = jax.random.PRNGKey(0)
    for i, a in enumerate(actions):
        obs, reward, terminated, truncated, _ = env.step(a)
        jstate, jobs, jreward, jterm, jtrunc = jenv.step(jstate, jnp.asarray(a), key)
        np.testing.assert_allclose(obs, np.asarray(jobs["state"]), atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(reward, float(jreward), rtol=1e-5, atol=1e-5)
        assert terminated is False and bool(jterm) is False
        assert truncated == bool(jtrunc) == (i == 199)
    assert obs.dtype == np.float32 and obs.shape == (3,)
    assert abs(obs[2]) <= 8.0
    assert env.observation_space.shape == (3,) and env.action_space.shape == (1,)
    # a reset is seeded: the same seed gives the same start
    np.testing.assert_array_equal(Pendulum(seed=3).reset()[0], Pendulum(seed=7).reset(seed=3)[0])


def test_make_env_routes_pendulum_only():
    from sheeprl_tpu_torch.utils.env import make_env

    env = make_env("Pendulum-v1", 5)()
    assert env.observation_space.shape == (3,)
    assert (env.action_space.low, env.action_space.high) == (-2.0, 2.0)
    np.testing.assert_array_equal(env.reset()[0], make_env("Pendulum-v1", 5)().reset()[0])
    with pytest.raises(ValueError, match="Pendulum-v1"):
        make_env("HalfCheetah-v4", 0)()


# ---------------------------------------------------------------------------
# the actor
# ---------------------------------------------------------------------------


def test_sac_actor_matches_the_reference():
    jactor, tactor = sac_actors(seed=1)
    obs = np.random.default_rng(2).standard_normal((7, OBS_DIM)).astype(np.float32)
    with torch.no_grad():
        greedy = tactor.get_greedy_actions(torch.from_numpy(obs)).numpy()
        mean, std = tactor.dist_params(torch.from_numpy(obs))
    np.testing.assert_allclose(greedy, np.asarray(jactor.get_greedy_actions(jnp.asarray(obs))), rtol=1e-5, atol=1e-7)
    jmean, jstd = jactor.dist_params(jnp.asarray(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=1e-5)
    # the reparameterized sample, fed the reference's own noise
    key = jax.random.PRNGKey(4)
    jact, jlogp = jactor(jnp.asarray(obs), key)
    noise = np.array(jax.random.normal(key, jmean.shape, jmean.dtype))
    with torch.no_grad():
        act, logp = tactor(torch.from_numpy(obs), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-5, atol=1e-5)
    assert tuple(logp.shape) == (7, 1)
    # with a generator the sample draws its own noise, reproducibly
    a1, _ = tactor(torch.from_numpy(obs), generator=torch.Generator().manual_seed(0))
    a2, _ = tactor(torch.from_numpy(obs), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    assert float(tactor.action_scale) == 2.0 and float(tactor.action_bias) == 0.0


def test_fused_sac_step_matches_the_reference_fused_step(pallas_interpret):
    from sheeprl_tpu.serve.quant import _make_fused_sac_step as jax_fused_step
    from sheeprl_tpu.serve.quant import _sac_fused_ready as jax_ready
    from sheeprl_tpu_torch.serve.policies import SACServePolicy
    from sheeprl_tpu_torch.serve.quant import _make_fused_sac_step, _sac_fused_ready

    jq_actor, tq_actor, _ = quantized_actors()
    policy = SACServePolicy(OBS_DIM, ACT_DIM, torch.device("cpu"))
    assert jax_ready(types.SimpleNamespace(algo="sac"), jq_actor)
    assert _sac_fused_ready(policy, tq_actor)
    obs = np.random.default_rng(9).standard_normal((4, OBS_DIM)).astype(np.float32)
    want = np.asarray(jax_fused_step()(jq_actor, jnp.asarray(obs)))
    with torch.inference_mode():
        got = _make_fused_sac_step()(tq_actor, torch.from_numpy(obs)).numpy()
        generic = tq_actor.get_greedy_actions(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the fused step and the QuantLinear path share int8_linear: identical here
    np.testing.assert_array_equal(got, generic)
    # the structural guard: an f32 actor, a normed trunk or another algo do not take it
    _, tactor = sac_actors()
    assert not _sac_fused_ready(policy, tactor)
    assert not _sac_fused_ready(types.SimpleNamespace(algo="dreamer_v3"), tq_actor)


# ---------------------------------------------------------------------------
# QuantState: acceptance, reload, persistence
# ---------------------------------------------------------------------------


def _quant_state(tmp_path, bound, ckpt=None, seed=3):
    from sheeprl_tpu_torch.serve.policies import SACServePolicy
    from sheeprl_tpu_torch.serve.quant import QuantState

    policy = SACServePolicy(OBS_DIM, ACT_DIM, torch.device("cpu"))
    return QuantState(policy, types.SimpleNamespace(quant_bound=bound, seed=seed, ckpt=ckpt), str(tmp_path))


def test_accept_rungs_tight_bound_keeps_f32(tmp_path):
    _, actor = sac_actors()
    qs = _quant_state(tmp_path, bound=1e-12)
    won = qs.accept_rungs(1, actor, [1, 2])
    assert won == set() and qs.int8_rungs == set() and qs.available
    for rung in (1, 2):
        d = qs.decisions[rung]
        assert d.winner == "f32" and d.baseline == "f32" and not d.accepted
        rep = d.candidate("int8")
        assert rep["within_bound"] is False and rep["divergence"] > 1e-12 and rep["bit_exact"] is False
        assert rep["exec_seconds"] > 0 and rep["peak_bytes"] is None  # no device memory on the CPU
    assert os.path.exists(qs.store_path)
    assert qs.gauges()["Serve/quant_fused"] == 1.0  # the plain version on the CPU, by device


def test_accept_rungs_loose_bound_makes_int8_eligible(tmp_path):
    from sheeprl_tpu_torch.compile import decisions as dec

    _, actor = sac_actors()
    qs = _quant_state(tmp_path, bound=10.0)
    qs.accept_rungs(1, actor, [1])
    d = qs.decisions[1]
    rep = d.candidate("int8")
    assert rep["within_bound"] is True and 0.0 < rep["divergence"] <= 10.0
    # the winner is the faster of the two: timing decides, the receipt only qualifies
    f32 = d.candidate("f32")["exec_seconds"]
    assert d.winner == ("int8" if rep["exec_seconds"] < f32 else "f32")
    g = qs.gauges()
    assert g["Serve/quant_enabled"] == 1.0 and g["Serve/quant_bound"] == 10.0
    assert g["Serve/quant_rungs"] == float(d.winner == "int8")
    # the store entry is the receipt; a re-run with the same key reads it back
    again = dec.cached_decision(qs.store_path, d.key)
    assert again.source == "cache" and again.winner == d.winner and again.quality_bound == 10.0


def test_decide_checks_its_arguments(tmp_path):
    from sheeprl_tpu_torch.compile import decisions as dec

    example = (torch.zeros(2, 3),)
    build = lambda label: (lambda x: x * 1.0)  # noqa: E731
    with pytest.raises(ValueError, match="come together"):
        dec.decide("f", "n", ["a", "b"], build, example, quality_bound=0.1)
    with pytest.raises(ValueError, match="duplicate"):
        dec.decide("f", "n", ["a", "a"], build, example)
    # a broken candidate aborts the decision with its error; a bit-exact one survives
    def build2(label):
        if label == "broken":
            def fn(x):
                raise RuntimeError("no kernel")
            return fn
        return lambda x: x + 0.0
    with pytest.raises(RuntimeError, match="no kernel"):
        dec.decide("f", "n", ["base", "same", "broken"], build2, example)
    d = dec.decide("f", "n", ["base", "same"], build2, example)
    assert d.candidate("same")["bit_exact"] and d.candidate("same")["exec_seconds"] > 0
    assert d.winner in ("base", "same")
    assert "|float32[2, 3]|torch" in d.key and d.key.endswith("|cpu")


def test_hot_reload_rederives_scales_in_the_reload_hook(tmp_path):
    from sheeprl_tpu_torch.serve.params import ParamsStore

    _, actor_v1 = sac_actors(seed=0)
    _, actor_v2 = sac_actors(seed=1)
    qs = _quant_state(tmp_path, bound=0.05)
    q1 = qs.params_for(1, actor_v1)
    assert qs.params_for(1, actor_v1) is q1 and qs.rederives == 0
    store = ParamsStore(lambda path: actor_v2, actor_v1, source="ckpt_1")
    store.on_reload = qs.params_for
    reply = store.reload()
    assert reply["ok"] and reply["version"] == 2 and qs.rederives == 1
    # a dispatch at the new version is a pure cache hit: no second derive
    q2 = qs.params_for(*store.current())
    assert q2 is qs._cache[1] and qs.rederives == 1
    assert not torch.equal(q2.fc_mean.w_q, q1.fc_mean.w_q)
    assert qs.gauges()["Serve/quant_rederives"] == 1.0


def test_reload_hook_failure_keeps_the_swap():
    from sheeprl_tpu_torch.serve.params import ParamsStore

    events = []
    telem = types.SimpleNamespace(event=lambda name, **data: events.append((name, data)))
    store = ParamsStore(lambda path: {"w": 2}, {"w": 1}, source="c", telem=telem)

    def boom(version, params):
        raise RuntimeError("hook exploded")

    store.on_reload = boom
    reply = store.reload()
    assert reply["ok"] and reply["version"] == 2 and store.current() == (2, {"w": 2})
    errs = [d for name, d in events if name == "serve.reload_hook_error"]
    assert errs and "hook exploded" in errs[0]["error"]


def test_scales_persist_next_to_the_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt_100")
    os.makedirs(ckpt)
    _, actor = sac_actors()
    qs = _quant_state(tmp_path, bound=0.05, ckpt=ckpt)
    qa = qs.params_for(1, actor)
    persisted = tq.load_scales(tq.scales_path(ckpt))
    assert sorted(persisted) == sorted(tq.linear_paths(actor))
    qb = _quant_state(tmp_path, bound=0.05, ckpt=ckpt, seed=77).params_for(1, actor)
    torch.testing.assert_close(qa.fc_mean.w_q, qb.fc_mean.w_q, rtol=0, atol=0)


def test_held_out_receipt_rows_overlap_calibration_in_both_packages(tmp_path):
    """A finding of the reference kept for parity (ROADMAP Queue C): the
    receipt set at rung r (seed + 1) is the first r rows of calibration
    batch 1, not a held-out draw."""
    from sheeprl_tpu.serve.quant import QuantState as JaxQuantState

    seed, rung = 3, 8
    port = _quant_state(tmp_path, bound=0.05, seed=seed)
    calib = [port._calib_inputs(1, None, 64, seed + i)[0].numpy() for i in range(4)]
    receipt = port._calib_inputs(1, None, rung, seed + 1)[0].numpy()
    np.testing.assert_array_equal(receipt, calib[1][:rung])
    jpolicy = types.SimpleNamespace(algo="sac", obs_dim=OBS_DIM)
    jqs = JaxQuantState(jpolicy, types.SimpleNamespace(quant_bound=0.05, seed=seed, ckpt=None), str(tmp_path))
    (jreceipt,) = jqs._calib_inputs(1, None, rung, seed + 1)
    (jcalib1,) = jqs._calib_inputs(1, None, 64, seed + 1)
    np.testing.assert_array_equal(jreceipt, jcalib1[:rung])
    np.testing.assert_array_equal(jreceipt, receipt)


# ---------------------------------------------------------------------------
# serve --algo sac --quant int8, end to end on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.timeout(120)
def test_served_answers_equal_direct_calls(tmp_path):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.policies import build_policy
    from sheeprl_tpu_torch.serve.quant import QuantState, _make_fused_sac_step

    rows_plan = [1, 3, 2, 1, 4, 3]
    argv = ["serve", "--device", "cpu", "--algo", "sac", "--quant", "int8", "--model_argv", SAC_MODEL,
            "--root_dir", str(tmp_path), "--run_name", "r", "--serve_requests", str(len(rows_plan)),
            "--max_batch", "4", "--deadline_ms", "0"]
    errors: list[BaseException] = []

    def _serve():
        try:
            run(argv)
        except BaseException as err:  # surfaced by the assertion below
            errors.append(err)

    server = threading.Thread(target=_serve, daemon=True)
    server.start()
    run_dir = os.path.join(str(tmp_path), "r")
    addr_file = os.path.join(run_dir, "serve_address")
    deadline = time.monotonic() + 60
    while not os.path.exists(addr_file) and not errors and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not errors, errors
    rng = np.random.default_rng(0)
    plan = [rng.standard_normal((n, OBS_DIM)).astype(np.float32) for n in rows_plan]
    answers = []
    with ServeClient(open(addr_file).read().strip()) as client:  # one client: one request a dispatch
        for obs in plan:
            res, meta = client.request({"obs": obs})
            assert meta["offset"] == 0 and meta["rows"] == len(obs)  # alone in its dispatch
            answers.append((res["actions"], meta["rung"]))
    server.join(timeout=60)
    assert not server.is_alive() and not errors, errors

    with open(os.path.join(run_dir, "telemetry.jsonl")) as fh:
        records = [json.loads(line) for line in fh if line.strip()]
    start = next(r for r in records if r.get("event") == "serve.start")
    assert start["quant"] == "int8" and start["rungs"] == [1, 2, 4]
    int8_rungs = set(start["int8_rungs"])
    assert len([r for r in records if r.get("event") == "serve.quant_rung"]) == 3
    gauges = [r for r in records if r.get("event") == "interval"][-1]["metrics"]
    assert gauges["Serve/quant_enabled"] == 1.0 and gauges["Serve/quant_fused"] == 1.0
    assert gauges["Serve/quant_rungs"] == float(len(int8_rungs))
    assert sum(gauges[f"Serve/dispatches_b{r}"] for r in (1, 2, 4)) == len(rows_plan)

    # the same weights and scales, rebuilt from the same argv and seed, called directly
    args = ServeArgs(device="cpu", algo="sac", model_argv=SAC_MODEL)
    policy, actor, _ = build_policy(args, torch.device("cpu"))
    qactor = QuantState(policy, types.SimpleNamespace(quant_bound=0.05, seed=args.seed, ckpt=None),
                        str(tmp_path / "direct")).params_for(1, actor)
    fused = _make_fused_sac_step()
    for obs, (got, rung) in zip(plan, answers):
        padded = np.zeros((rung, OBS_DIM), np.float32)
        padded[: len(obs)] = obs
        with torch.inference_mode():
            if rung in int8_rungs:
                want = fused(qactor, torch.from_numpy(padded))
            else:
                want = actor.get_greedy_actions(torch.from_numpy(padded))
        assert got.shape == (len(obs), ACT_DIM)
        np.testing.assert_array_equal(got, want.numpy()[: len(obs)])
        assert np.all(np.abs(got) <= 2.0)


def test_serve_raises_when_the_int8_trunk_fails(tmp_path, monkeypatch):
    """A trunk that fails to build or launch stops the serve process: the
    rungs never step aside to f32 for it."""
    import sheeprl_tpu_torch.serve.quant as quant_mod
    from sheeprl_tpu_torch.cli import run

    def broken(*args):
        raise RuntimeError("fused_int8_trunk_forward launch failed: CUDA error 1")

    monkeypatch.setattr(quant_mod, "fused_int8_trunk", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        run(["serve", "--device", "cpu", "--algo", "sac", "--quant", "int8", "--model_argv", SAC_MODEL,
             "--root_dir", str(tmp_path), "--run_name", "r", "--dry_run"])
    assert not os.path.exists(os.path.join(str(tmp_path), "r", "serve_address"))


def test_sac_serve_without_cuda_raises_unless_cpu_is_asked(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["serve", "--algo", "sac", "--quant", "int8", "--model_argv", SAC_MODEL,
             "--root_dir", str(tmp_path), "--dry_run"])


def test_quant_options_are_checked(tmp_path):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.serve.args import ServeArgs

    with pytest.raises(ValueError, match="quant must be"):
        run(["serve", "--device", "cpu", "--algo", "sac", "--quant", "int4",
             "--root_dir", str(tmp_path), "--dry_run"])
    with pytest.raises(ValueError, match="quant_bound"):
        ServeArgs(quant_bound=0.0)
    assert ServeArgs().quant_bound == 0.05
