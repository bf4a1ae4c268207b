"""The port's `utils/metric.py` and `utils/profiler.py` against the
reference's.

- `MetricAggregator`: the same update stream into both packages'
  aggregators (Python floats, numpy scalars, and one-element arrays: JAX
  arrays on the reference's side, torch tensors on the port's): every
  interval's computed dict equal (both take float64 means of the same
  float32 values), the moving average surviving the interval reset, the
  snapshot resolving to what `compute()` gave when it was taken.
- `StepProfiler`: a window of `steps` updates opens at the first tick and
  closes at the `steps + 1`-th, leaving a chrome trace under
  `<log_dir>/profile` that holds the window's operations and
  `profile.start`/`profile.stop` telemetry events; inactive, nothing.
- The mains on the CPU: `--profile` through PPO's and SAC's CLIs leaves a
  trace and the events, and the metrics record keeps its keys.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _stream(seed: int, n: int):
    rng = np.random.default_rng(seed)
    for i in range(n):
        v = np.float32(rng.normal() * 10)
        yield ("Loss/a", v, i % 3)  # kind 0 float, 1 numpy scalar, 2 array/tensor
        yield ("Rewards/rew_avg", np.float32(rng.uniform(-1, 1)), (i + 1) % 3)
        if i % 4 == 0:
            yield ("Game/ep_len_avg", np.float32(rng.integers(1, 50)), 0)


def _value(v, kind: int, pkg: str):
    if kind == 0:
        return float(v)
    if kind == 1:
        return v
    return jnp.asarray(v) if pkg == "ref" else torch.tensor(v)


@pytest.mark.parametrize("seed", [0, 1])
def test_metric_aggregator_matches_the_reference(seed):
    from sheeprl_tpu.utils import metric as ref
    from sheeprl_tpu_torch.utils import metric as port

    aggs = {pkg: mod.MetricAggregator() for pkg, mod in (("port", port), ("ref", ref))}
    for pkg, mod in (("port", port), ("ref", ref)):
        aggs[pkg].add("Window", mod.MovingAverageMetric(window=5))
    updates = list(_stream(seed, 30))
    outs = {"port": [], "ref": []}
    snaps = {"port": [], "ref": []}
    for j, (name, v, kind) in enumerate(updates):
        for pkg, agg in aggs.items():
            agg.update(name, _value(v, kind, pkg))
            agg.update("Window", _value(v, kind, pkg))
        if j % 17 == 16:  # a logging interval
            for pkg, agg in aggs.items():
                snaps[pkg].append(agg.snapshot())
                outs[pkg].append(agg.compute())
                agg.reset()
    for pkg, agg in aggs.items():
        outs[pkg].append(agg.compute())
    assert outs["port"] == outs["ref"] and len(outs["port"]) >= 4
    assert all("Window/mean" in o and "Window/std" in o for o in outs["port"])
    for pkg in aggs:  # a snapshot resolves to the compute() of its moment
        assert [s.resolve() for s in snaps[pkg]] == outs[pkg][:-1]
    aggs["port"].reset(force=True)
    assert aggs["port"].compute() == {}
    with pytest.raises(ValueError, match="already exists"):
        aggs["port"].add("Window")


def test_empty_metrics_are_left_out_as_the_reference_leaves_them():
    from sheeprl_tpu.utils import metric as ref
    from sheeprl_tpu_torch.utils import metric as port

    got = []
    for mod in (port, ref):
        agg = mod.MetricAggregator()
        agg.add("Loss/a")
        agg.update("Loss/b", 2.0)
        agg.pop("Loss/c")
        got.append(agg.compute())
    assert got[0] == got[1] == {"Loss/b": 2.0}


def test_step_profiler_writes_a_bounded_window(tmp_path):
    from sheeprl_tpu_torch.telemetry.core import Telemetry
    from sheeprl_tpu_torch.utils.profiler import StepProfiler

    telem = Telemetry(str(tmp_path), role="learner")
    args = type("A", (), {"profile": True, "profile_steps": 2})()
    prof = StepProfiler.from_args(args, str(tmp_path))
    x = torch.ones(64, 64)
    ticks = []
    for _ in range(5):
        x = torch.tanh(x @ x / 64)
        prof.tick()
        ticks.append(prof.active)
    prof.close()  # a second close is harmless
    telem.close()
    assert ticks == [True, True, False, False, False]
    trace = tmp_path / "profile" / "trace.json"
    assert prof.trace_path == str(trace) and trace.exists()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with open(tmp_path / "telemetry.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    assert [r["event"] for r in records if r["event"].startswith("profile.")] == ["profile.start", "profile.stop"]
    off = StepProfiler.from_args(type("A", (), {"profile": False})(), str(tmp_path / "off"))
    off.tick()
    off.close()
    assert not off.active and not os.path.exists(tmp_path / "off")


@pytest.mark.timeout(300)
@pytest.mark.parametrize("algo", ["ppo", "sac"])
def test_profile_flag_through_the_cli(algo, tmp_path):
    """`--profile --profile_steps 2` leaves a trace under the run's
    `profile/`, the telemetry records the window and the phase times, and
    the "done" record names the trace."""
    from sheeprl_tpu_torch.cli import run

    if algo == "ppo":
        argv = ["ppo", "--env_id", "CartPole-v1", "--num_envs", "2", "--rollout_steps", "8",
                "--per_rank_batch_size", "4", "--update_epochs", "1", "--total_steps", "64"]
    else:
        argv = ["sac", "--num_envs", "1", "--actor_hidden_size", "8", "--critic_hidden_size", "8",
                "--per_rank_batch_size", "8", "--learning_starts", "8", "--buffer_size", "64", "--total_steps",
                "220"]
    run([*argv, "--device", "cpu", "--profile", "--profile_steps", "2", "--root_dir", str(tmp_path),
         "--run_name", "r"])
    run_dir = tmp_path / "r"
    with open(run_dir / "metrics.jsonl") as fh:
        done = [json.loads(line) for line in fh][-1]
    assert done["event"] == "done" and done["profile"] == str(run_dir / "profile" / "trace.json")
    assert (run_dir / "profile" / "trace.json").exists()
    with open(run_dir / "telemetry.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    events = [r["event"] for r in records]
    assert events[0] == "start" and events[-1] == "end" and "profile.start" in events and "profile.stop" in events
    interval = [r for r in records if r["event"] == "interval"][-1]["metrics"]
    assert "Time/rollout_seconds" in interval and "Compile/plan_entries" in interval
