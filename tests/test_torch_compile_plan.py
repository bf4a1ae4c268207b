"""`sheeprl_tpu_torch/compile/plan.py` on the CPU, and the steps it graphs
on the card, held to the reference.

There are no CUDA graphs here, so the plan runs in its two CPU modes:
"direct" (every `--device cpu` run: a `WarmJit` calls its step) and
"static" (the copy machinery of a graph without the graph: the first call
runs eagerly, later calls copy their tensors into static inputs, run the
step on them and copy its results into static outputs that the next call
overwrites; non-tensor arguments are frozen at the capture, as a graph
freezes them). The CUDA-graph path itself is in `tests/test_torch_cuda.py`
(marked `cuda`).

- A `WarmJit` on the CPU equals a direct call; static mode equals direct
  calls over steps in which tau (1, 0.02, 0), the annealed PPO values and
  the exploration amount change, bit for bit, through the CLIs of
  `dreamer_v3`, `ppo` and `serve` (with `--warm_compile on` and `off`);
- a shape drift counts one fallback and writes its event; a capture that
  fails raises; the launch counts read eager calls + replays x a capture's
  launches; the gauge keys are the reference's less its cache counters;
- two DreamerV3 gradient steps (tau 1, then 0.02) and two PPO updates with
  annealed lr, clip and entropy coefficients, through the device-scalar
  steps in static mode, against the reference: DreamerV3's metrics at the
  one-step test's rtol 1e-3 / atol 1e-4, its parameters at 2 * 2 * lr +
  1e-6 (each Adam step can move a parameter by up to 2 * lr where the two
  sides' rounding flips a near-zero gradient's sign: two steps, twice the
  one-step bound); PPO's losses, parameters and Adam moments at the
  one-update test's rtol 1e-5 / atol 1e-6;
- `Moments` keeps its tensors' identity through updates and loads, and
  five updates match the reference's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.compile import plan as plan_mod
from sheeprl_tpu_torch.compile.plan import CompilePlan
from sheeprl_tpu_torch.ops.kernels import gru


class _Events:
    def __init__(self):
        self.records = []

    def event(self, name, **data):
        self.records.append((name, data))


def _static(**kw) -> CompilePlan:
    return CompilePlan(mode="static", **kw)


def test_warmjit_on_the_cpu_is_a_direct_call():
    plan = CompilePlan(device="cpu")
    calls = []

    def step(x, scale):
        calls.append(x)
        return x * scale

    wj = plan.register("step", step)
    x = torch.arange(4.0)
    assert plan.mode == "direct" and torch.equal(wj(x, 2.0), x * 2.0) and calls[0] is x
    plan.start()
    assert torch.equal(wj(x, 3.0), x * 3.0)  # a float that changes is no drift on the CPU
    g = plan.gauges()
    assert g["Compile/plan_compiled"] == 0 and g["Compile/aot_calls"] == 0 and g["Compile/aot_fallbacks"] == 0


def test_static_outputs_are_overwritten_and_inputs_copied():
    """The graph's aliasing, shown on the CPU: a later call returns the
    same output tensors with new values, and the step reads the static
    copies of its inputs, not the caller's tensors."""
    plan = _static()
    wj = plan.register("step", lambda x, y: {"sum": x + y, "prod": x * y})
    a, b = torch.tensor([1.0, 2.0]), torch.tensor([3.0, 4.0])
    first = wj(a, b)  # eager: its own tensors
    second = wj(b, a)
    third = wj(a, a)
    assert second["sum"] is third["sum"] and torch.equal(third["sum"], a + a)
    assert torch.equal(first["sum"], a + b)
    assert plan.stats()["entries"]["step"]["aot_calls"] == 2


def test_shape_drift_counts_one_fallback():
    events = _Events()
    plan = _static(telem=events)
    wj = plan.register("step", lambda x, k: x * k)
    wj(torch.ones(3), 2)
    wj(torch.ones(3), 2)
    out = wj(torch.ones(5), 2)  # shape drift
    assert torch.equal(out, torch.full((5,), 2.0))
    out = wj(torch.ones(3), 3)  # a non-tensor argument that changes is drift too
    assert torch.equal(out, torch.full((3,), 3.0))
    stats = plan.stats()["entries"]["step"]
    assert stats["fallbacks"] == 2 and stats["aot_calls"] == 1 and stats["eager_calls"] == 3
    assert plan.gauges()["Compile/aot_fallbacks"] == 2.0
    assert [n for n, _ in events.records].count("compile.fallback") == 2


class _CountingBackend:
    """A capture that runs its step once (as a graph's capture runs the
    Python of the step, launching nothing) and a replay that runs nothing."""

    def warm(self, fn, args, device):
        return fn(*args)

    def capture(self, fn, args, device, like):
        return (lambda: None), fn(*args), 0


def test_launch_counts_read_replays_times_the_captures_launches():
    """The wrappers' counters move only where a wrapper launches: the eager
    warm-up and the capture (which records its launches into the graph).
    A replay runs no Python and moves none; the plan only reads the
    counters around the capture, so replays x `launches_per_replay` is what
    the device runs (`chip_smoke.py` counts that with torch.profiler)."""
    plan = _static()
    plan._backend = _CountingBackend()

    def step(x):
        gru.layernorm_gru_cell.launches += 3  # three "launches" a call
        return x + 1

    wj = plan.register("step", step)
    start = gru.layernorm_gru_cell.launches
    try:
        wj(torch.zeros(2))  # eager warm-up (3 launches), then the capture (3 recorded)
        assert gru.layernorm_gru_cell.launches == start + 6
        for _ in range(5):
            wj(torch.zeros(2))
        assert gru.layernorm_gru_cell.launches == start + 6  # the plan writes no counter
        stats = plan.stats()["entries"]["step"]
        assert stats["launches_per_replay"] == {"layernorm_gru_cell": 3}
        assert stats["aot_calls"] * stats["launches_per_replay"]["layernorm_gru_cell"] == 5 * 3
    finally:
        gru.layernorm_gru_cell.launches = start


def test_a_capture_that_fails_raises():
    class Broken(_CountingBackend):
        def capture(self, fn, args, device, like):
            raise RuntimeError("operation not permitted when stream is capturing")

    events = _Events()
    plan = _static(telem=events)
    plan._backend = Broken()
    wj = plan.register("step", lambda x: x + 1)
    with pytest.raises(RuntimeError, match="capturing step as a CUDA graph failed"):
        wj(torch.zeros(2))
    assert plan.stats()["entries"]["step"]["error"].startswith("RuntimeError")
    assert any(n == "compile" and d.get("error") for n, d in events.records)


def test_gauge_keys_match_the_reference():
    from sheeprl_tpu.compile.plan import CompilePlan as RefPlan

    ref = RefPlan(enabled=True)
    f = jax.jit(lambda x: x * 2.0)
    ref_step = ref.register("train_step", f, example=lambda: (jnp.ones(3),), role="update")
    ref.start()
    assert ref.wait(60)
    ref_step(jnp.ones(3))
    ref.close()

    plan = _static(enabled=True)
    step = plan.register("train_step", lambda x: x * 2.0, example=lambda: (torch.ones(3),), role="update")
    plan.start()
    step(torch.ones(3))
    plan.close()
    cache = {"Compile/cache_hits", "Compile/cache_misses"}
    assert set(plan.gauges()) == set(ref.gauges()) - cache
    assert set(plan.stats()) >= {"enabled", "entries", "time_to_first_update_seconds"}


def test_warm_on_leaves_the_state_as_it_was():
    """`start()` warms up on the example and restores what it touched:
    parameters, and an optimizer's state zeroed where the warm-up made it."""
    from sheeprl_tpu_torch.ops.optim import adam, apply_gradients

    lin = torch.nn.Linear(3, 2)
    opt = adam(lin.parameters(), 0.1, 1e-8)
    before = {k: v.clone() for k, v in lin.state_dict().items()}

    def step(model, optimizer, x):
        loss = model(x).square().sum()
        params = list(model.parameters())
        apply_gradients(params, torch.autograd.grad(loss, params), optimizer, None)
        return loss.detach()

    plan = _static(enabled=True)
    wj = plan.register("step", step, example=lambda: (lin, opt, torch.ones(4, 3)))
    plan.start()
    assert all(torch.equal(lin.state_dict()[k], v) for k, v in before.items())
    assert all(float(st["step"]) == 0 and not st["exp_avg"].any() for st in opt.state.values())
    # the first real step after it equals a fresh optimizer's first step
    fresh = torch.nn.Linear(3, 2)
    fresh.load_state_dict(before)
    fresh_opt = adam(fresh.parameters(), 0.1, 1e-8)
    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(wj(lin, opt, x), step(fresh, fresh_opt, x))
    assert all(torch.equal(lin.state_dict()[k], v) for k, v in fresh.state_dict().items())


class _Normaliser:
    """State made at its first update, with a fresh value that is not 0
    (as `Moments` makes its percentile pair when it moves devices)."""

    def __init__(self):
        self.q = None
        self.count = torch.zeros(())

    def update(self, x):
        if self.q is None:
            self.q = torch.tensor([0.05, 0.95])
        self.count.add_(1)
        return x * self.q[1]

    def state_dict(self):
        return {"count": self.count.clone()}

    def load_state_dict(self, state):
        self.count.copy_(state["count"])


def test_warm_on_restores_only_known_state():
    """`start()` puts back what it knows a warm-up changes, through each
    object's own `state_dict`, and never guesses at tensors the warm-up
    made: a lazily built tensor whose fresh value is not 0 keeps it; an
    optimizer state it cannot reset raises."""
    norm = _Normaliser()
    plan = _static(enabled=True)
    plan.register("step", lambda n, x: n.update(x), example=lambda: (norm, torch.ones(2)))
    plan.start()
    assert float(norm.count) == 0 and torch.equal(norm.q, torch.tensor([0.05, 0.95]))

    lin = torch.nn.Linear(2, 1)
    sgd = torch.optim.SGD(lin.parameters(), lr=0.1, momentum=0.9)

    def step(model, optimizer, x):
        model(x).sum().backward()
        optimizer.step()
        return x

    plan = _static(enabled=True)
    plan.register("sgd", step, example=lambda: (lin, sgd, torch.ones(3, 2)))
    with pytest.raises(RuntimeError, match="momentum_buffer"):
        plan.start()


# ---------------------------------------------------------------------------
# static mode against direct calls, through the entry points
# ---------------------------------------------------------------------------


def _use_static_plans(monkeypatch) -> None:
    """Every later `CompilePlan.from_args` of the process in static mode."""
    original = CompilePlan.from_args

    def from_args(args, telem=None):
        plan = original(args, telem)
        plan.mode, plan._backend = "static", plan_mod._StaticBuffers()
        return plan

    monkeypatch.setattr(CompilePlan, "from_args", staticmethod(from_args))


def _records(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


DV3_TINY = ["--device", "cpu", "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--cnn_channels_multiplier", "2",
            "--dense_units", "16", "--hidden_size", "16", "--recurrent_state_size", "16", "--stochastic_size", "4",
            "--discrete_size", "4", "--per_rank_batch_size", "2", "--per_rank_sequence_length", "4", "--horizon",
            "3", "--learning_starts", "16", "--total_steps", "48", "--train_every", "2", "--buffer_size", "64",
            "--critic_target_network_update_freq", "2", "--expl_amount", "0.5", "--expl_decay",
            "--max_step_expl_decay", "4"]


def _dv3_run(tmp_path, name, warm):
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    dreamer_v3.main([*DV3_TINY, "--root_dir", str(tmp_path), "--run_name", name, "--warm_compile", warm])
    return _records(os.path.join(tmp_path, name, "metrics.jsonl"))


@pytest.mark.timeout(600)
@pytest.mark.parametrize("warm", ["off", "on"])
def test_dreamer_v3_static_buffers_equal_direct_calls(tmp_path, monkeypatch, warm):
    """tau takes 1, then 0.02 and 0 in turns (update every second step),
    the exploration amount decays from 0.5 to its minimum: the static
    machinery reads each from its device scalar and equals the direct run
    bit for bit, losses and parameters."""
    direct = _dv3_run(tmp_path, "direct", "off")
    _use_static_plans(monkeypatch)
    static = _dv3_run(tmp_path, "static", warm)

    def rows(records):
        return [{k: v for k, v in r.items() if k != "sps"} for r in records if "Loss/policy_loss" in r]

    assert len(rows(direct)) >= 5 and len({r["Params/exploration_amount"] for r in rows(direct)}) > 2
    assert rows(static) == rows(direct)
    done_d, done_s = direct[-1], static[-1]
    for k in ("Params/world_model_delta", "Params/actor_delta", "Params/critic_delta", "test_returns"):
        assert done_d[k] == done_s[k], k
    g = done_s["compile"]
    assert g["Compile/plan_compiled"] == 2 and g["Compile/aot_fallbacks"] == 0 and g["Compile/aot_calls"] > 0


PPO_TINY = ["--device", "cpu", "--num_envs", "2", "--rollout_steps", "8", "--per_rank_batch_size", "4",
            "--update_epochs", "2", "--total_steps", "48", "--dense_units", "16", "--mlp_features_dim", "16",
            "--cnn_features_dim", "32", "--anneal_lr", "--anneal_clip_coef", "--anneal_ent_coef", "--ent_coef", "0.01"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("env", ["CartPole-v1", "Pendulum-v1", "multidiscrete_dummy"])
@pytest.mark.parametrize("warm", ["off", "on"])
def test_ppo_static_buffers_equal_direct_calls(tmp_path, monkeypatch, env, warm):
    """lr, clip and entropy coefficients annealed over 3 updates: the
    static machinery equals the direct run bit for bit, with no fallback."""
    from sheeprl_tpu_torch.algos.ppo import ppo

    ppo.main([*PPO_TINY, "--env_id", env, "--root_dir", str(tmp_path), "--run_name", "direct"])
    _use_static_plans(monkeypatch)
    ppo.main([*PPO_TINY, "--env_id", env, "--root_dir", str(tmp_path), "--run_name", "static", "--warm_compile", warm])
    keys = ("Loss/policy_loss", "Loss/value_loss", "Loss/entropy_loss", "Info/learning_rate")
    a, b = _records(tmp_path / "direct" / "metrics.jsonl"), _records(tmp_path / "static" / "metrics.jsonl")
    ua, ub = [r for r in a if "update" in r], [r for r in b if "update" in r]
    assert len(ua) == 3 and len({r["Info/learning_rate"] for r in ua}) == 3
    assert [[r[k] for k in keys] for r in ua] == [[r[k] for k in keys] for r in ub]
    assert a[-1]["test_returns"] == b[-1]["test_returns"]
    g = b[-1]["compile"]
    assert g["Compile/plan_compiled"] == 2 and g["Compile/aot_fallbacks"] == 0 and g["Compile/aot_calls"] > 0
    sa = torch.load(tmp_path / "direct" / "checkpoints" / "ckpt_3" / "state.pt", weights_only=False)
    sb = torch.load(tmp_path / "static" / "checkpoints" / "ckpt_3" / "state.pt", weights_only=False)
    assert all(torch.equal(sa["agent"][k], sb["agent"][k]) for k in sa["agent"])
    assert sb["optimizer"]["param_groups"][0]["lr"] == sa["optimizer"]["param_groups"][0]["lr"]
    assert isinstance(sb["optimizer"]["param_groups"][0]["lr"], float)


def _serve(tmp_path, name, argv, requests):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.serve.client import ServeClient

    root = str(tmp_path / name)
    failures = []

    def _run():
        try:
            run(["serve", "--device", "cpu", *argv, "--root_dir", root, "--run_name", "s", "--deadline_ms", "0",
                 "--serve_requests", str(len(requests))])
        except BaseException as err:  # reported below
            failures.append(err)

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    addr = os.path.join(root, "s", "serve_address")
    deadline = time.monotonic() + 120
    while not os.path.exists(addr):
        assert not failures and time.monotonic() < deadline, failures
        time.sleep(0.05)
    out = []
    with ServeClient(open(addr).read().strip()) as client:
        for obs, kw in requests:
            out.append(client.request(obs, **kw)[0]["actions"])
    t.join(60)
    assert not failures and not t.is_alive()
    recs = _records(os.path.join(root, "s", "telemetry.jsonl"))
    return out, [r for r in recs if r.get("event") == "interval"][-1]["metrics"]


DV3_SERVE = ["--model_argv", "--env_id discrete_dummy --cnn_keys rgb --cnn_channels_multiplier 2 --dense_units 16 "
             "--hidden_size 16 --recurrent_state_size 16 --stochastic_size 4 --discrete_size 4"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("algo", ["dreamer_v3", "sac"])
@pytest.mark.parametrize("warm", ["off", "on"])
def test_serve_static_buffers_equal_direct_calls(tmp_path, monkeypatch, algo, warm):
    """Every served answer of a static-mode server equals the direct
    server's: sessions keep their rows across dispatches although each
    dispatch overwrites the rung's static outputs (the rows are copies);
    SAC int8 and f32 rungs alike (a loose bound admits int8; both servers
    take the direct one's timed decisions)."""
    rng = np.random.default_rng(0)
    if algo == "sac":
        argv = ["--algo", "sac", "--quant", "int8", "--model_argv", "--actor_hidden_size 32", "--quant_bound", "10"]
        requests = [({"obs": rng.standard_normal((1 + i % 3, 3)).astype(np.float32)}, {}) for i in range(12)]
    else:
        argv = DV3_SERVE
        requests = [({"rgb": rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)},
                     {"session": f"s{i % 2}", "reset": i == 7}) for i in range(12)]
    want, _ = _serve(tmp_path, "direct", [*argv, "--warm_compile", warm], requests)
    if algo == "sac":  # the same int8 rungs: the direct server's timed decisions, read from its store
        os.makedirs(tmp_path / "static" / "s")
        shutil.copy(tmp_path / "direct" / "s" / "serve_quant.json", tmp_path / "static" / "s" / "serve_quant.json")
    _use_static_plans(monkeypatch)
    got, gauges = _serve(tmp_path, "static", [*argv, "--warm_compile", warm], requests)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))
    assert gauges["Compile/aot_fallbacks"] == 0 and gauges["Compile/aot_calls"] > 0
    assert gauges["Compile/plan_compiled"] == (4 if warm == "on" else len({1, 2, 4} if algo == "sac" else {1}))


def test_graph_params_copy_a_new_version_into_the_held_object():
    from sheeprl_tpu_torch.serve.params import GraphParams

    held = GraphParams()
    v1, v2 = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    assert held.sync("f32", 1, v1) is v1
    weight = v1.weight
    assert held.sync("f32", 2, v2) is v1 and v1.weight is weight
    assert torch.equal(v1.weight, v2.weight) and torch.equal(v1.bias, v2.bias)
    assert held.sync("int8", 2, v2) is v2  # each kind holds its own object


# ---------------------------------------------------------------------------
# the device-scalar steps against the reference, two steps each
# ---------------------------------------------------------------------------


@pytest.mark.timeout(900)
def test_two_dreamer_v3_gradient_steps_match_the_reference():
    """tau 1 at the first step, 0.02 at the second (the schedule's EMA):
    the port's device step in static mode against the reference's two
    steps, the second on the first's state."""
    from sheeprl_tpu import ops
    from sheeprl_tpu.algos.dreamer_v3.agent import build_models as ref_models
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args as RefArgs
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import DV3TrainState as RefState
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_optimizers as ref_optimizers
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as ref_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRICS, make_train_step
    from sheeprl_tpu_torch.interop import state_dict_from_jax
    from tests.test_torch_dv3_train import A, CNN_KEYS, KEY_SEED, MLP_KEYS, TINY, VECTOR, _batch, _noise, _port_state
    from tests.test_torch_interop import jax_flat

    import gymnasium as gym

    args = RefArgs(**TINY)
    space = {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8),
             "state": gym.spaces.Box(-np.inf, np.inf, (VECTOR,), np.float32)}
    wm, actor, critic, target = ref_models(jax.random.PRNGKey(0), [A], False, args, space, CNN_KEYS, MLP_KEYS)
    wopt, aopt, copt = ref_optimizers(args)
    ref = RefState(world_model=wm, actor=actor, critic=critic, target_critic=target, world_opt=wopt.init(wm),
                   actor_opt=aopt.init(actor), critic_opt=copt.init(critic),
                   moments=ops.Moments.init(args.moments_decay, args.moment_max, args.moments_percentile_low,
                                            args.moments_percentile_high))
    names = ("world_model", "actor", "critic", "target_critic")
    before = {n: jax_flat(getattr(ref, n)) for n in names}
    step = ref_train_step(args, wopt, aopt, copt, CNN_KEYS, MLP_KEYS, [A], False)
    data = {k: jnp.asarray(v) for k, v in _batch().items()}
    ref_metrics = []
    for i, tau in enumerate((1.0, 0.02)):
        ref, m = step(ref, data, jax.random.PRNGKey(KEY_SEED + i), jnp.float32(tau))
        ref_metrics.append({k: float(v) for k, v in m.items()})

    port_args, state = _port_state(before)
    plan = _static()
    port_step = make_train_step(port_args, CNN_KEYS, MLP_KEYS, [A], False, plan=plan)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    for i, tau in enumerate((1.0, 0.02)):
        metrics = port_step(state, batch, tau, _noise(jax.random.PRNGKey(KEY_SEED + i)))
        for name in METRICS:
            np.testing.assert_allclose(metrics[name], ref_metrics[i][name], rtol=1e-3, atol=1e-4,
                                       err_msg=f"step {i}: {name}")
    assert plan.stats()["entries"]["train_step"]["aot_calls"] == 1
    np.testing.assert_allclose([float(state.moments.low), float(state.moments.high)],
                               [float(ref.moments.low), float(ref.moments.high)], rtol=1e-3, atol=1e-5)
    lrs = {"world_model": port_args.world_lr, "actor": port_args.actor_lr, "critic": port_args.critic_lr,
           "target_critic": 0.02 * port_args.critic_lr}
    for name in names:
        module = getattr(state, name)
        want = state_dict_from_jax(module, jax_flat(getattr(ref, name)))
        for path, got in module.state_dict().items():
            np.testing.assert_allclose(got.numpy(), want[path].numpy(), rtol=0, atol=2 * 2 * lrs[name] + 1e-6,
                                       err_msg=f"{name}.{path}")


@pytest.mark.timeout(600)
def test_two_ppo_updates_with_annealed_values_match_the_reference():
    from sheeprl_tpu.algos.ppo.ppo import TrainState
    from sheeprl_tpu.algos.ppo.ppo import make_optimizer as ref_optimizer
    from sheeprl_tpu.algos.ppo.ppo import make_train_step as ref_step
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step
    from sheeprl_tpu_torch.interop import adam_state_from_jax, flatten_params
    from sheeprl_tpu_torch.nn.layers import Linear
    from tests.test_torch_interop import jax_flat
    from tests.test_torch_ppo import N, T, _adam_of, _agents, _reference_permutations, _rollout, _t, _update_args

    ref_args, args = _update_args(0.5, True)
    ref_agent, agent = _agents("cartpole", mlp_features_dim=16)
    num_minibatches = T * N // args.per_rank_batch_size
    optax_opt = ref_optimizer(ref_args)
    ref_update = ref_step(ref_args, optax_opt, num_minibatches)
    ref_state = TrainState(agent=ref_agent, opt_state=optax_opt.init(ref_agent))
    optimizer = make_optimizer(args, agent)
    plan = _static()
    update = make_train_step(args, num_minibatches, plan=plan)
    schedule = [(3e-3, 0.2, 0.01), (1.5e-3, 0.1, 0.005)]  # linear annealing over two updates
    for i, (lr, clip, ent) in enumerate(schedule):
        data = _rollout(11 + i)
        key = jax.random.PRNGKey(2 + i)
        ref_state, ref_metrics = ref_update(ref_state, {k: jnp.asarray(v) for k, v in data.items()}, key,
                                            jnp.float32(lr), jnp.float32(clip), jnp.float32(ent))
        metrics = update(agent, optimizer, {k: _t(v) for k, v in data.items()}, lr, clip, ent,
                         perms=_t(_reference_permutations(key, args.update_epochs, T * N)))
        for k, v in metrics.items():
            np.testing.assert_allclose(v, float(ref_metrics[k]), rtol=1e-5, atol=1e-7, err_msg=f"update {i}: {k}")
    stats = plan.stats()["entries"]["minibatch_step"]
    assert stats["aot_calls"] == 2 * args.update_epochs * num_minibatches - 1 and stats["fallbacks"] == 0
    linear = {f"{n}.weight" for n, m in agent.named_modules() if isinstance(m, Linear)}
    want_params = flatten_params(jax_flat(ref_state.agent))
    for name, p in agent.named_parameters():
        want = want_params[name].T if name in linear else want_params[name]
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5, atol=1e-6, err_msg=name)
    want_opt = adam_state_from_jax(agent, optimizer, _adam_of(ref_state.opt_state))
    got_opt = optimizer.state_dict()
    for i, st in want_opt["state"].items():
        assert float(got_opt["state"][i]["step"]) == float(st["step"]) == 2 * args.update_epochs * num_minibatches
        for side in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(got_opt["state"][i][side].numpy(), st[side].numpy(), rtol=1e-5, atol=1e-6)


def test_ppo_update_copies_its_batch_into_the_captured_step_once(monkeypatch):
    """Once the minibatch step is captured, an update copies its rollout
    batch into the step's static batch once and passes that, so a replay
    copies only the index and the three scalars; the updates equal direct
    ones bit for bit."""
    from sheeprl_tpu_torch.algos.ppo.ppo import make_optimizer, make_train_step
    from tests.test_torch_ppo import N, T, _agents, _rollout, _t, _update_args

    _, args = _update_args(0.5, True)
    num_minibatches = T * N // args.per_rank_batch_size
    runs = {}
    for mode in ("direct", "static"):
        torch.manual_seed(0)
        _, agent = _agents("cartpole", mlp_features_dim=16)
        optimizer = make_optimizer(args, agent)
        plan = CompilePlan(mode=mode)
        update = make_train_step(args, num_minibatches, plan=plan)
        passed = []
        if mode == "static":
            original = plan_mod.WarmJit.__call__

            def spy(self, *a):
                passed.append(a[2])
                return original(self, *a)

            monkeypatch.setattr(plan_mod.WarmJit, "__call__", spy)
        metrics = []
        for i in range(2):
            data = {k: _t(v) for k, v in _rollout(11 + i).items()}
            metrics.append(update(agent, optimizer, data, 3e-3, 0.2, 0.01, generator=torch.Generator().manual_seed(i)))
        monkeypatch.undo()
        runs[mode] = (metrics, [p.detach().clone() for p in agent.parameters()], passed, data, plan)
    metrics, params, passed, data, plan = runs["static"]
    assert metrics == runs["direct"][0]
    assert all(torch.equal(a, b) for a, b in zip(params, runs["direct"][1]))
    static = plan._entries[0].static_args[2]
    assert len(passed) == 2 * args.update_epochs * num_minibatches
    assert passed[0] is not static and all(p is static for p in passed[1:])
    assert all(torch.equal(static[k], v) for k, v in data.items())  # the last update's batch


# ---------------------------------------------------------------------------
# Moments: device-resident state, updated in place
# ---------------------------------------------------------------------------


def test_moments_keep_their_tensors_and_match_the_reference_over_five_updates():
    from sheeprl_tpu import ops
    from sheeprl_tpu_torch.ops.moments import Moments

    ref, port = ops.Moments.init(0.9, 1e8, 0.05, 0.95), Moments(0.9, 1e8, 0.05, 0.95)
    low, high, q = port.low, port.high, port.q
    rng = np.random.default_rng(4)
    for i in range(5):
        x = (rng.normal(size=(15, 8, 1)) * (i + 1)).astype(np.float32)
        ref, (ref_off, ref_inv) = ref.update(jnp.asarray(x))
        off, inv = port.update(torch.from_numpy(x))
        assert port.low is low and port.high is high and port.q is q
        np.testing.assert_allclose([float(off), float(inv)], [float(ref_off), float(ref_inv)], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose([float(port.low), float(port.high)], [float(ref.low), float(ref.high)],
                               rtol=1e-6, atol=1e-7)
    saved = port.state_dict()
    port.update(torch.ones(4))
    assert float(saved["low"]) != float(port.low)  # the saved state is a copy
    port.load_state_dict(saved)
    assert port.low is low and float(port.low) == float(saved["low"])
