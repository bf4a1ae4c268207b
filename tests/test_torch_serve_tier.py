"""The rest of the port's serving tier on the CPU, against the JAX package
where it has a counterpart: DreamerV3 `--quant int8` (calibration,
the quantized step, rung acceptance, persisted scales), calibration from a
replay buffer, the memory-sized ladder and its memoized probe, the
occupancy re-tier, `--reload_poll_s`, request spans and PROFILE frames.

Sizes are `tests/test_torch_interop.py`'s tiny DreamerV3 player (64x64x3
pixels plus a 5-vector, discrete actions) and `tests/test_torch_int8.py`'s
SAC actor (hidden 32), weights carried across by `interop`, inputs from
seeded numpy generators. Every DreamerV3 parity check runs the reference
under `pallas_interpret`, its TPU path: there its GRU cell takes the
kernel branch, which reads the recurrent projection's weight without
calling the Linear, so that Linear gets no scale, as in the port.

Tolerances: calibration scales atol 1e-6 (an absmax over activations the
two packages compute in f32 with sums in other orders, divided by 127);
the quantized step's actions exactly and its recurrent and stochastic
states atol 1e-5 (as `tests/test_torch_dv3_player.py`: f32 sums in other
orders through the encoder and the GRU; the int8 products are exact);
persisted scales and the twin they give exactly; served answers exactly
(the same computation as the direct call)."""

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
from sheeprl_tpu.ops import quant as jq
from sheeprl_tpu_torch.ops import quant as tq
from tests.test_torch_int8 import HIDDEN, OBS_DIM, calib_batches, sac_actors
from tests.test_torch_interop import TINY_DV3, jax_flat, tiny_players

SEED = 3
S, D = TINY_DV3["stochastic_size"], TINY_DV3["discrete_size"]
SCALE_ATOL = 1e-6
STATE_ATOL = 1e-5
SAC_MODEL = f"--actor_hidden_size {HIDDEN}"
# the one Linear of a player step that a gated calibration never sees
GRU_PROJ = "rssm.recurrent_model.rnn.proj"


@pytest.fixture
def pallas_interpret():
    pk.set_pallas(True, interpret=True)
    yield
    pk.set_pallas(None, interpret=False)


def _args(bound: float = 0.05, ckpt: str | None = None, seed: int = SEED):
    return types.SimpleNamespace(quant_bound=bound, seed=seed, ckpt=ckpt)


def _reference_gumbel(rows: int) -> torch.Tensor:
    """The Gumbel noise of the reference's served step at `rows` rows: its
    posterior sample is drawn from PRNGKey(0)'s first split
    (`tests/test_torch_dv3_player.py` holds the identity)."""
    k_repr = jax.random.split(jax.random.PRNGKey(0), 3)[0]
    return torch.from_numpy(np.array(jax.random.gumbel(k_repr, (rows, S, D))))


def dv3_policies(gumbel: torch.Tensor | None = None):
    """(reference policy, port policy) over the tiny player's spaces; the
    port's noise is `gumbel` ([S, D] shared by every row, or [rows, S, D])."""
    import gymnasium as gym

    from sheeprl_tpu.serve.policies import DV3ServePolicy as JaxPolicy
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.serve.policies import DV3ServePolicy

    jspace = {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8),
              "state": gym.spaces.Box(-np.inf, np.inf, (5,), np.float32)}
    tspace = {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-np.inf, np.inf, (5,))}
    if gumbel is None:
        gumbel = torch.from_numpy(np.random.default_rng(7).gumbel(size=(S, D)).astype(np.float32))
    return (JaxPolicy(jspace, ["rgb"], ["state"]),
            DV3ServePolicy(tspace, ["rgb"], ["state"], torch.device("cpu"), gumbel))


def _calibrations(tmp_path, gated: bool = True):
    """(reference scales, port scales) of the tiny player through each
    package's `QuantState._calibrate`, the port's step given the
    reference's per-row noise."""
    from sheeprl_tpu.serve.quant import QuantState as JaxQuantState
    from sheeprl_tpu_torch.serve.quant import QuantState

    jplayer, tplayer = tiny_players()
    jpol, tpol = dv3_policies(_reference_gumbel(64))
    want = JaxQuantState(jpol, _args(), str(tmp_path / "j"))._calibrate(1, jplayer)
    got = QuantState(tpol, _args(), str(tmp_path / "t"))._calibrate(1, tplayer)
    return want, got


# ---------------------------------------------------------------------------
# DreamerV3 --quant int8
# ---------------------------------------------------------------------------


def test_dv3_calibration_matches_the_gated_reference(tmp_path, pallas_interpret):
    want, got = _calibrations(tmp_path)
    # of the tiny player's 11 Linears, the step calls 9; the gated reference
    # and the port scale 8, the GRU's projection left out
    assert sorted(got) == sorted(want) and len(got) == 8 and GRU_PROJ not in got
    for path in want:
        assert got[path].dtype == np.float32 and got[path].shape == want[path].shape
        np.testing.assert_allclose(got[path], want[path], rtol=0, atol=SCALE_ATOL, err_msg=path)


def test_calibration_coverage_depends_on_the_reference_gate(tmp_path):
    """The reference's plain path (gate off) calls the GRU's projection and
    so scales it too, 9 Linears at the tiny structure; its gated path and
    the port, 8 (a finding in the reference, mirrored: the port follows the
    TPU path)."""
    want, got = _calibrations(tmp_path)
    assert len(want) == 9 and GRU_PROJ in want
    assert sorted(got) == sorted(p for p in want if p != GRU_PROJ)


def test_dv3_calib_inputs_follow_the_reference(tmp_path):
    from sheeprl_tpu.serve.quant import QuantState as JaxQuantState
    from sheeprl_tpu_torch.serve.quant import QuantState

    jplayer, tplayer = tiny_players()
    jpol, tpol = dv3_policies()
    jstate, jobs = JaxQuantState(jpol, _args(), str(tmp_path / "j"))._calib_inputs(1, jplayer, 6, SEED + 1)
    tstate, tobs = QuantState(tpol, _args(), str(tmp_path / "t"))._calib_inputs(1, tplayer, 6, SEED + 1)
    assert list(tobs) == list(jobs) == ["rgb", "state"]
    for k in jobs:
        assert tobs[k].dtype == {"rgb": torch.uint8, "state": torch.float32}[k]
        np.testing.assert_array_equal(tobs[k].numpy(), jobs[k])
    for k in jstate:
        assert tuple(tstate[k].shape) == jstate[k].shape
        np.testing.assert_allclose(tstate[k].numpy(), jstate[k], rtol=0, atol=STATE_ATOL)


def test_dv3_quantized_step_matches_the_reference(tmp_path, pallas_interpret):
    from sheeprl_tpu_torch.interop import state_dict_from_jax

    jplayer, tplayer = tiny_players()
    want, _ = _calibrations(tmp_path)
    jtwin = jq.quantize_linears(jplayer, want)
    ttwin = tq.quantize_linears(tplayer, want)
    # the port's twin, quantized from the same scales, is the reference's
    sd = ttwin.state_dict()
    for k, v in state_dict_from_jax(ttwin, jax_flat(jtwin)).items():
        assert torch.equal(sd[k], v), k
    assert isinstance(ttwin.rssm.recurrent_model.rnn.proj, type(tplayer.rssm.recurrent_model.rnn.proj))
    assert ttwin.encoder is not tplayer.encoder and ttwin.rssm.recurrent_model.rnn is tplayer.rssm.recurrent_model.rnn
    rows = 8
    jpol, tpol = dv3_policies(_reference_gumbel(rows))
    rng = np.random.default_rng(11)
    init = {k: np.repeat(np.asarray(v)[None], rows, 0) for k, v in jpol._init_row(1, jplayer).items()}
    for _ in range(3):  # three chained steps from the init rows
        obs = {"rgb": rng.integers(0, 256, (rows, 64, 64, 3), dtype=np.uint8),
               "state": rng.standard_normal((rows, 5)).astype(np.float32)}
        jstate, jacts = jpol.step(jtwin, {k: jnp.asarray(v) for k, v in init.items()},
                                  {k: jnp.asarray(v) for k, v in obs.items()})
        with torch.inference_mode():
            tstate, tacts = tpol.step(ttwin, {k: torch.from_numpy(np.asarray(v)) for k, v in init.items()},
                                      {k: torch.from_numpy(v) for k, v in obs.items()})
        np.testing.assert_array_equal(tacts.numpy(), np.asarray(jacts))
        np.testing.assert_array_equal(tstate["actions"].numpy(), np.asarray(jstate["actions"]))
        for k in ("recurrent", "stochastic"):
            np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]), rtol=0, atol=STATE_ATOL, err_msg=k)
        init = {k: np.asarray(v) for k, v in jstate.items()}


@pytest.mark.parametrize("bound", [1e-12, 10.0])
def test_dv3_accept_rungs(tmp_path, bound):
    """A tight bound keeps every rung on f32 (the stochastic one-hot state
    moves by a whole 1 where one sample flips, and the recurrent state by
    the int8 rounding); a loose one makes int8 eligible and timing picks."""
    from sheeprl_tpu_torch.serve.quant import QuantState

    _, tplayer = tiny_players()
    _, tpol = dv3_policies()
    qs = QuantState(tpol, _args(bound), str(tmp_path))
    won = qs.accept_rungs(1, tplayer, [1, 2])
    assert qs.available and not qs._fused and qs.step_for(None) == tpol.step
    for rung in (1, 2):
        d = qs.decisions[rung]
        rep, f32 = d.candidate("int8"), d.candidate("f32")
        assert rep["divergence"] > 1e-12 and rep["exec_seconds"] > 0 and rep["bit_exact"] is False
        if bound < 1:
            assert d.winner == "f32" and rep["within_bound"] is False
        else:
            assert rep["within_bound"] is True
            assert d.winner == ("int8" if rep["exec_seconds"] < f32["exec_seconds"] else "f32")
    assert won == {r for r in (1, 2) if qs.decisions[r].winner == "int8"} == qs.int8_rungs


def test_reference_written_scales_load_in_the_port(tmp_path, pallas_interpret):
    """A `quant_scales.npz` the reference persisted beside a checkpoint (on
    its gated path) is read by the port's QuantState as "persisted" and
    gives the reference's twin."""
    from sheeprl_tpu.serve.quant import QuantState as JaxQuantState
    from sheeprl_tpu_torch.interop import state_dict_from_jax
    from sheeprl_tpu_torch.serve.quant import QuantState

    ckpt = str(tmp_path / "ckpt_8")
    os.makedirs(ckpt)
    jplayer, tplayer = tiny_players()
    jpol, tpol = dv3_policies(_reference_gumbel(64))
    jtwin = JaxQuantState(jpol, _args(ckpt=ckpt), str(tmp_path / "j")).params_for(1, jplayer)
    assert os.path.exists(tq.scales_path(ckpt))
    events = []
    telem = types.SimpleNamespace(event=lambda name, **data: events.append((name, data)))
    qs = QuantState(tpol, _args(ckpt=ckpt, seed=99), str(tmp_path / "t"), telem=telem)
    ttwin = qs.params_for(1, tplayer)
    assert [d["source"] for n, d in events if n == "serve.quant_scales"] == ["persisted"]
    sd = ttwin.state_dict()
    for k, v in state_dict_from_jax(ttwin, jax_flat(jtwin)).items():
        assert torch.equal(sd[k], v), k


def test_graph_params_keep_each_kind_consistent_across_a_reload(tmp_path):
    """The twin shares the GRU, the convs and the norms with its player, so
    a reload's copy into the held f32 player moves the held twin's shared
    modules too; the twin's own dispatch then copies its whole new version
    in, and each kind reads one whole version at its dispatch."""
    import copy

    from sheeprl_tpu_torch.serve.params import GraphParams
    from sheeprl_tpu_torch.serve.quant import QuantState

    p1, p2 = (copy.deepcopy(tiny_players(seed)[1]) for seed in (0, 1))
    _, tpol = dv3_policies()
    qs = QuantState(tpol, _args(), str(tmp_path))
    t1 = qs.params_for(1, p1)
    held = GraphParams()
    assert held.sync("f32", 1, p1) is p1 and held.sync("int8", 1, t1) is t1
    t2 = qs.params_for(2, p2)
    assert qs.rederives == 1 and t2.rssm.recurrent_model.rnn is p2.rssm.recurrent_model.rnn
    assert held.sync("f32", 2, p2) is p1
    assert held.sync("int8", 2, t2) is t1
    for held_obj, fresh in ((p1, p2), (t1, t2)):
        got = held_obj.state_dict()
        assert all(torch.equal(got[k], v) for k, v in fresh.state_dict().items())
    state, obs = qs._calib_inputs(2, p2, 4, SEED)
    with torch.inference_mode():
        for held_obj, fresh in ((p1, p2), (t1, t2)):
            (s_held, a_held), (s_fresh, a_fresh) = tpol.step(held_obj, state, obs), tpol.step(fresh, state, obs)
            assert torch.equal(a_held, a_fresh) and all(torch.equal(s_held[k], s_fresh[k]) for k in s_fresh)


# ---------------------------------------------------------------------------
# calibration over a replay buffer
# ---------------------------------------------------------------------------


class _StubBuffer:
    """`sample(n)` -> the next of the given batches under `obs_key`."""

    def __init__(self, batches, as_tensor: bool):
        self._batches = iter(batches)
        self._as_tensor = as_tensor

    def sample(self, batch_size: int) -> dict:
        b = next(self._batches)
        assert len(b) == batch_size
        return {"obs": torch.from_numpy(b) if self._as_tensor else b}


def test_calibrate_from_buffer_matches_the_reference():
    jactor, tactor = sac_actors()
    batches = calib_batches(seed=5)
    want = jq.calibrate_from_buffer(jactor, lambda m, obs: m.get_greedy_actions(jnp.asarray(obs)),
                                    _StubBuffer(batches, as_tensor=False))
    got = tq.calibrate_from_buffer(tactor, lambda m, obs: m.get_greedy_actions(obs),
                                   _StubBuffer(batches, as_tensor=True))
    assert sorted(got) == sorted(want) == ["fc_logstd", "fc_mean", "model.layers.0", "model.layers.1"]
    np.testing.assert_array_equal(got["model.layers.0"], want["model.layers.0"])
    for path in ("model.layers.1", "fc_mean", "fc_logstd"):
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6, atol=1e-6 * want[path].max(), err_msg=path)


def test_calibrate_from_buffer_follows_the_replay_buffers_seed():
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer

    _, tactor = sac_actors()
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((128, 1, OBS_DIM)).astype(np.float32)

    def scales(seed: int) -> dict:
        buf = ReplayBuffer(128, 1, storage="host", device="cpu", obs_keys=("obs",), seed=seed)
        buf.add({"obs": rows})
        return tq.calibrate_from_buffer(tactor, lambda m, obs: m.get_greedy_actions(obs), buf, batch_size=16)

    a, b, c = scales(0), scales(0), scales(1)
    assert sorted(a) == sorted(tq.linear_paths(tactor))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a[k], c[k]) for k in a)


# ---------------------------------------------------------------------------
# the ladder: parse, derive, size, memoize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    ("auto", 8), ("auto", 6), ("auto", 1), ("4,1,2", 8), ("2,1,2", 2), ("16", 8), ("0,2", 8), ("a,b", 8), ("", 8),
])
def test_parse_rungs_as_the_reference(case):
    import sheeprl_tpu.serve.ladder as jl
    import sheeprl_tpu_torch.serve.ladder as tl

    def outcome(mod):
        try:
            return mod.parse_rungs(*case)
        except ValueError as err:
            return str(err)

    assert outcome(tl) == outcome(jl)


@pytest.mark.parametrize("case", [
    (3.0, [1, 2, 8], 8), (5.2, [1, 2, 8], 8), (0.0, [1, 2, 8], 8), (2.2, [1, 2, 8], 8), (9.0, [1, 2, 8], 8),
    (7.4, [1, 2, 8], 8), (4.0, [1, 8], 8), (6.0, [1, 8], 8), (6.6, [1, 8], 8), (2.5, [1, 4], 4), (-1.0, [1], 1),
])
def test_derive_rung_as_the_reference(case):
    import sheeprl_tpu.serve.ladder as jl
    import sheeprl_tpu_torch.serve.ladder as tl

    assert tl.derive_rung(*case) == jl.derive_rung(*case)


def test_ladder_spec_and_budget(monkeypatch):
    import sheeprl_tpu.serve.ladder as jl
    import sheeprl_tpu_torch.serve.ladder as tl

    for algo in ("sac", "dreamer_v3"):
        assert tl.ledger_spec(algo) == jl.ledger_spec(algo)
    monkeypatch.delenv("SHEEPRL_TPU_SERVE_MEM_MB", raising=False)
    monkeypatch.delenv("SHEEPRL_TPU_PARTITION_MEM_MB", raising=False)
    assert tl.serve_mem_budget_bytes() == jl.serve_mem_budget_bytes() == 512 * 2**20
    monkeypatch.setenv("SHEEPRL_TPU_SERVE_MEM_MB", "1.5")
    assert tl.serve_mem_budget_bytes() == jl.serve_mem_budget_bytes() == int(1.5 * 2**20)


def _fake_probe(peaks: dict, calls: list):
    def probe(fn, example):
        rung = int(example[0].shape[0])
        calls.append(rung)
        if peaks[rung] is None:
            return {"error": "probe call failed: RuntimeError: boom"}
        return {"peak_bytes": peaks[rung], "argument_bytes": 10, "rise_bytes": peaks[rung] - 10}
    return probe


def test_size_ladder_rules_and_cache(monkeypatch, tmp_path):
    import sheeprl_tpu_torch.serve.ladder as tl

    calls: list = []
    monkeypatch.setattr(tl, "_probe", _fake_probe({1: 50, 2: 90, 4: 200, 8: None}, calls))
    store = str(tmp_path / "serve_ladder.json")
    example_of = lambda r: (torch.zeros(r, 3),)  # noqa: E731
    dec = tl.size_ladder(None, example_of, [1, 2, 4, 8], "serve", mem_budget_bytes=100, store_path=store)
    assert [(d.rung, d.accepted, d.source, d.peak_bytes) for d in dec] == [
        (1, True, "probe", 50), (2, True, "probe", 90), (4, False, "probe", 200), (8, True, "error", 0)]
    assert "within budget" in dec[0].reason and "> budget" in dec[2].reason and "boom" in dec[3].reason
    assert calls == [1, 2, 4, 8]
    # a second sizing reads the measured peaks back; the failed probe runs again
    dec2 = tl.size_ladder(None, example_of, [1, 2, 4, 8], "serve", mem_budget_bytes=100, store_path=store)
    assert calls == [1, 2, 4, 8, 8]
    assert [d.as_event() for d in dec2[:3]] == [dict(d.as_event(), reason=d.reason.replace("(probe)", "(probe cache)"))
                                                for d in dec[:3]]
    # the decision is drawn anew from the budget: the smallest rung is kept over it
    dec3 = tl.size_ladder(None, example_of, [2, 4], "serve", mem_budget_bytes=60, store_path=store)
    assert [(d.rung, d.accepted, d.source) for d in dec3] == [(2, True, "floor"), (4, False, "probe")]
    assert "EXCEEDS" in dec3[0].reason
    with open(store) as fh:
        entries = json.load(fh)
    assert len(entries) == 3 and all(e["family"] == "serve_ladder" and "probe" in e for e in entries.values())


def test_size_ladder_probes_a_real_step_on_the_cpu(tmp_path):
    """On the CPU the probe counts the arguments (the actor's parameters,
    the rung's obs) and the outputs of one call."""
    import sheeprl_tpu_torch.serve.ladder as tl
    from sheeprl_tpu_torch.serve.policies import SACServePolicy

    _, actor = sac_actors()
    policy = SACServePolicy(OBS_DIM, 1, torch.device("cpu"))
    store = str(tmp_path / "serve_ladder.json")
    dec = tl.size_ladder(policy.step, lambda r: policy.example(actor, r), [1, 8], "serve", store_path=store)
    param_b = sum(p.numel() * 4 for p in actor.parameters()) + sum(b.numel() * b.element_size()
                                                                  for b in actor.buffers())
    for d, rung in zip(dec, (1, 8)):
        assert d.accepted and d.source == "probe"
        assert d.peak_bytes == param_b + rung * OBS_DIM * 4 + rung * 1 * 4
    # a shared storage counts once
    assert tl.example_arg_bytes((actor, actor, policy.obs_buffer(8))) == param_b + 8 * OBS_DIM * 4


def test_measured_probe_caches_measurements_not_failures(tmp_path):
    from sheeprl_tpu_torch.compile import decisions as dec

    store = str(tmp_path / "d.json")
    example = (torch.zeros(2, 3),)
    n = []

    def measure():
        n.append(1)
        return {"peak_bytes": 7}

    assert dec.measured_probe("fam", "x", example, measure, store_path=store) == ({"peak_bytes": 7}, "measured")
    assert dec.measured_probe("fam", "x", example, measure, store_path=store) == ({"peak_bytes": 7}, "cache")
    assert dec.measured_probe("fam", "x", example, measure, store_path=store, force=True)[1] == "measured"
    assert len(n) == 2
    # another shape is another key
    assert dec.measured_probe("fam", "x", (torch.zeros(4, 3),), measure, store_path=store)[1] == "measured"
    key = dec.decision_key("fam", "x", example)
    assert dec.load_cache(store)[key]["probe"] == {"peak_bytes": 7}
    failed = lambda: {"error": "nope"}  # noqa: E731
    assert dec.measured_probe("fam", "y", example, failed, store_path=store) == ({"error": "nope"}, "measured")
    assert dec.decision_key("fam", "y", example) not in dec.load_cache(store)


# ---------------------------------------------------------------------------
# the batcher: re-tier and the served decomposition
# ---------------------------------------------------------------------------


def _batcher(rungs=(1, 2, 8)):
    from sheeprl_tpu_torch.serve.batcher import MicroBatcher

    def dispatch(stacked, pendings, rung):
        return {"y": stacked["x"] * 2.0}, 1

    return MicroBatcher(dispatch, list(rungs), window_ms=0.0, default_deadline_ms=0)


@pytest.mark.parametrize("new, match", [([1, 8], "may only add"), ([1, 2, 4], "may only add"),
                                        ([1, 2, 8, 16], "keep the max rung")])
def test_set_rungs_refusals(new, match):
    b = _batcher()
    with pytest.raises(ValueError, match=match):
        b.set_rungs(new)
    assert b.rungs == [1, 2, 8]


def test_set_rungs_expands_and_dispatches_at_the_new_rung():
    b = _batcher()
    b.set_rungs([8, 4, 2, 1, 4])
    assert b.rungs == [1, 2, 4, 8] and b.max_rung == 8
    p = b.submit({"x": np.ones((3, 2), np.float32)})
    assert b.flush_once() == 1
    np.testing.assert_array_equal(p.wait(1.0)["y"], np.full((3, 2), 2.0, np.float32))
    assert p.rung == 4 and b.gauges()["Serve/dispatches_b4"] == 1.0
    assert min(p.pad_ms, p.dispatch_ms, p.slice_ms, p.queue_ms) >= 0.0


# ---------------------------------------------------------------------------
# serve end to end on the CPU: the re-tier and --reload_poll_s
# ---------------------------------------------------------------------------


def _records(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "telemetry.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _serve_thread(argv, run_dir):
    from sheeprl_tpu_torch.cli import run

    errors: list = []

    def _serve():
        try:
            run(argv)
        except BaseException as err:  # surfaced by the caller's assertions
            errors.append(err)

    t = threading.Thread(target=_serve, daemon=True)
    t.start()
    addr_file = os.path.join(run_dir, "serve_address")
    deadline = time.monotonic() + 60
    while not os.path.exists(addr_file) and not errors and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not errors, errors
    return open(addr_file).read().strip(), t, errors


@pytest.mark.timeout(120)
def test_retier_adds_the_occupied_rung(tmp_path):
    """SAC with `--ladder 1,8` and one client sending 4-row requests: every
    dispatch pads 4 rows to 8, so the re-tier sizes and adds rung 4; the
    answers at either rung equal the direct call on the same rows."""
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.policies import build_policy

    n = 240
    argv = ["serve", "--device", "cpu", "--algo", "sac", "--model_argv", SAC_MODEL, "--ladder", "1,8",
            "--max_batch", "8", "--deadline_ms", "0", "--serve_requests", str(n),
            "--root_dir", str(tmp_path), "--run_name", "r"]
    run_dir = os.path.join(str(tmp_path), "r")
    address, server, errors = _serve_thread(argv, run_dir)
    rng = np.random.default_rng(4)
    answers = []
    with ServeClient(address) as client:
        for _ in range(n):
            obs = rng.standard_normal((4, OBS_DIM)).astype(np.float32)
            res, meta = client.request({"obs": obs})
            answers.append((obs, res["actions"], meta["rung"]))
            time.sleep(0.01)  # a steady stream, spread over several re-tier looks
    server.join(timeout=60)
    assert not server.is_alive() and not errors, errors
    records = _records(run_dir)
    ladder = [r for r in records if r.get("event") == "serve.ladder"]
    assert [(r["rung"], r["accepted"], r["source"]) for r in ladder] == [(1, True, "probe"), (8, True, "probe")]
    assert not [r for r in records if r.get("event") == "serve.retier_error"]
    (retier,) = [r for r in records if r.get("event") == "serve.retier"]
    assert retier["rung"] == 4 and retier["accepted"] and retier["occupancy_rows"] == 4.0
    assert "probe" in retier["reason"] and not [r for r in records if r.get("event") == "serve.retier_error"]
    rungs = [rung for _, _, rung in answers]
    first4 = rungs.index(4)
    assert set(rungs[:first4]) == {8} and set(rungs[first4:]) == {4} and len(rungs) - first4 >= 10
    gauges = [r for r in records if r.get("event") == "interval"][-1]["metrics"]
    assert gauges["Serve/rungs"] == 3.0 and gauges["Serve/dispatches_b4"] == len(rungs) - first4
    policy, actor, _ = build_policy(ServeArgs(device="cpu", algo="sac", model_argv=SAC_MODEL), torch.device("cpu"))
    for obs, got, rung in answers:
        padded = np.zeros((rung, OBS_DIM), np.float32)
        padded[:4] = obs
        with torch.inference_mode():
            want = policy.step(actor, torch.from_numpy(padded)).numpy()[:4]
        np.testing.assert_array_equal(got, want)


def _sac_checkpoint(path: str, seed: int) -> None:
    from sheeprl_tpu_torch.algos.sac.args import SACArgs
    from sheeprl_tpu_torch.utils.checkpoint import save_checkpoint

    _, actor = sac_actors(seed=seed)
    save_checkpoint(path, {"agent": {"actor": actor.state_dict()}}, args=SACArgs(actor_hidden_size=HIDDEN))


@pytest.mark.timeout(120)
def test_reload_poll_moves_to_a_newer_checkpoint(tmp_path):
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.policies import build_policy
    from sheeprl_tpu_torch.utils.checkpoint import latest_checkpoint

    ckpts = tmp_path / "run" / "checkpoints"
    first, second = str(ckpts / "ckpt_10"), str(ckpts / "ckpt_20")
    _sac_checkpoint(first, seed=0)
    n = 60
    argv = ["serve", "--device", "cpu", "--algo", "sac", "--ckpt", first, "--reload_poll_s", "0.05",
            "--max_batch", "2", "--deadline_ms", "0", "--serve_requests", str(n),
            "--root_dir", str(tmp_path), "--run_name", "r"]
    run_dir = os.path.join(str(tmp_path), "r")
    address, server, errors = _serve_thread(argv, run_dir)
    rng = np.random.default_rng(8)
    answers = []
    with ServeClient(address) as client:
        for i in range(n):
            if i == 10:
                os.makedirs(str(ckpts / "ckpt_30.tmp-1"))  # a write in progress is not a checkpoint
                _sac_checkpoint(second, seed=1)
            obs = rng.standard_normal((1, OBS_DIM)).astype(np.float32)
            res, meta = client.request({"obs": obs})
            answers.append((obs, res["actions"], meta["version"]))
            time.sleep(0.02)
    server.join(timeout=60)
    assert not server.is_alive() and not errors, errors
    assert latest_checkpoint(str(ckpts)) == second
    versions = [v for _, _, v in answers]
    assert versions[:10] == [1] * 10 and versions[-1] == 2 and sorted(versions) == versions
    reloads = [r for r in _records(run_dir) if r.get("event") == "serve.reload"]
    assert [(r["ok"], r["version"], r["path"]) for r in reloads] == [(True, 2, second)]
    args = ServeArgs(device="cpu", algo="sac", ckpt=first)
    policy, actor1, loader = build_policy(args, torch.device("cpu"))
    actors = {1: actor1, 2: loader(second)}
    for obs, got, version in answers:
        with torch.inference_mode():
            want = policy.step(actors[version], torch.from_numpy(obs)).numpy()
        np.testing.assert_array_equal(got, want)


def test_latest_checkpoint_skips_an_uncommitted_write(tmp_path):
    """What the poller reloads: the newest checkpoint with its commit marker
    and sidecar, never a newer directory whose write has not committed."""
    from sheeprl_tpu_torch.utils.checkpoint import latest_checkpoint

    d = tmp_path / "checkpoints"
    _sac_checkpoint(str(d / "ckpt_5"), seed=0)
    os.makedirs(str(d / "ckpt_9"))  # no marker, no sidecar
    assert latest_checkpoint(str(d)) == str(d / "ckpt_5")
    assert latest_checkpoint(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# spans and PROFILE frames, on a server over a stub dispatch
# ---------------------------------------------------------------------------


def _server(tmp_path, rungs=(1, 2)):
    """A started ServeServer of SAC's contract whose dispatch doubles the
    obs, with a real Telemetry in `tmp_path`."""
    from sheeprl_tpu_torch.serve.batcher import MicroBatcher
    from sheeprl_tpu_torch.serve.params import ParamsStore
    from sheeprl_tpu_torch.serve.policies import SACServePolicy
    from sheeprl_tpu_torch.serve.server import ServeServer
    from sheeprl_tpu_torch.telemetry.core import Telemetry

    telem = Telemetry(str(tmp_path), role="serve")
    batcher = MicroBatcher(lambda stacked, pendings, rung: ({"actions": stacked["obs"] * 2.0}, 1), list(rungs),
                           window_ms=0.0, default_deadline_ms=0, telem=telem)
    server = ServeServer(SACServePolicy(OBS_DIM, 1, torch.device("cpu")), ParamsStore(lambda p: None, None),
                         batcher, telem=telem)
    return server, telem, server.start()


def _spans(tmp_path) -> list[dict]:
    return [r for r in _records(str(tmp_path)) if r.get("event") == "span"]


def test_request_spans_parent_echo_and_decomposition(tmp_path, monkeypatch):
    import sheeprl_tpu_torch.serve.client as client_mod
    from sheeprl_tpu_torch.flock import wire
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.errors import OversizedRequest
    from sheeprl_tpu_torch.serve.server import pack_request, unpack_request

    monkeypatch.delenv("SHEEPRL_TPU_TRACE", raising=False)
    server, telem, address = _server(tmp_path)
    sent = []
    real_pack = client_mod.pack_request
    monkeypatch.setattr(client_mod, "pack_request", lambda meta, obs: (sent.append(dict(meta)), real_pack(meta, obs))[1])
    try:
        with ServeClient(address) as client:
            res, meta = client.request({"obs": np.ones((2, OBS_DIM), np.float32)})
            np.testing.assert_array_equal(res["actions"], np.full((2, OBS_DIM), 2.0, np.float32))
            with pytest.raises(OversizedRequest):
                client.request({"obs": np.ones((3, OBS_DIM), np.float32)})
        # a raw REQUEST with a known parent, and its replay under the same id
        sock = wire.connect(address, timeout=10)
        wire.send_json(sock, wire.HELLO, {"proto": 1})
        wire.recv_json(sock, wire.WELCOME)
        payload = pack_request({"id": "raw-1", "span": "c0ffee01"}, {"obs": np.zeros((1, OBS_DIM), np.float32)})
        for _ in range(2):
            wire.send_frame(sock, wire.REQUEST, payload)
            kind, reply = wire.recv_frame(sock)
            assert kind == wire.RESPONSE
        raw_meta, _ = unpack_request(reply)
        sock.close()
    finally:
        server.close()
        telem.close()
    spans = {s["span"]: s for s in _spans(tmp_path)}
    assert len(spans) == 4 and all(s["name"] == "request" for s in spans.values())
    # the client's span ids rode the REQUEST metas and parent the server's spans
    assert len(sent) == 2 and all(len(m["span"]) == 8 for m in sent)
    served = spans[meta["span"]]
    assert served["parent"] == sent[0]["span"] and served["id"] == sent[0]["id"]
    assert served["outcome"] == "served" and served["rung"] == 2 and served["rows"] == 2
    for k in ("queue_ms", "pad_ms", "dispatch_ms", "slice_ms", "send_ms"):
        assert served[k] >= 0.0, k
    assert served["t1"] >= served["t0"] and served["dur_ms"] >= 0.0
    (err,) = [s for s in spans.values() if s["outcome"] == "error"]
    assert err["parent"] == sent[1]["span"] and err["kind"] == "oversized"
    raw = spans[raw_meta["span"]]
    assert raw["parent"] == "c0ffee01" and raw["outcome"] == "served"
    (replay,) = [s for s in spans.values() if s["outcome"] == "replay"]
    assert replay["parent"] == "c0ffee01" and replay["id"] == "raw-1"


def test_trace_kill_switch(tmp_path, monkeypatch):
    import sheeprl_tpu_torch.serve.client as client_mod
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.telemetry import trace

    monkeypatch.setenv("SHEEPRL_TPU_TRACE", "0")
    assert not trace.trace_enabled()
    server, telem, address = _server(tmp_path)
    sent = []
    real_pack = client_mod.pack_request
    monkeypatch.setattr(client_mod, "pack_request", lambda meta, obs: (sent.append(dict(meta)), real_pack(meta, obs))[1])
    try:
        with ServeClient(address) as client:
            _, meta = client.request({"obs": np.ones((1, OBS_DIM), np.float32)})
    finally:
        server.close()
        telem.close()
    assert "span" not in sent[0] and "span" not in meta and _spans(tmp_path) == []
    assert not telem.tracer.enabled and telem.tracer.begin("x") is None and telem.tracer.end(None) is None


def test_tracer_ids_and_spans(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.telemetry import trace
    from sheeprl_tpu_torch.telemetry.core import Telemetry, active_telemetry, emit

    monkeypatch.delenv(trace.RUN_ENV, raising=False)
    monkeypatch.delenv("SHEEPRL_TPU_TRACE", raising=False)
    rid = trace.ensure_run_id()
    assert len(rid) == 8 and os.environ[trace.RUN_ENV] == rid and trace.ensure_run_id() == rid
    ids = {trace.new_span_id() for _ in range(1000)}
    assert len(ids) == 1000 and all(len(i) == 8 and int(i, 16) >= 0 for i in ids)
    telem = Telemetry(str(tmp_path), role="serve")
    assert telem in active_telemetry()
    span = telem.tracer.begin("wait", parent="p", rows=3)
    time.sleep(0.01)
    sid = telem.tracer.end(span, outcome="done")
    emit("custom.event", value=1)
    telem.close()
    assert telem not in active_telemetry() and telem.tracer.begin("late") is None
    emit("after.close")  # reaches no closed writer
    records = _records(str(tmp_path))
    (span,) = [r for r in records if r.get("event") == "span"]
    assert span["span"] == sid and span["parent"] == "p" and span["rows"] == 3 and span["outcome"] == "done"
    assert span["name"] == "wait" and span["dur_ms"] >= 10.0 and span["t1"] > span["t0"]
    assert [r["value"] for r in records if r.get("event") == "custom.event"] == [1]
    assert not [r for r in records if r.get("event") == "after.close"]


def _wait_closed(window, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while window.active and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not window.active


def test_profile_frame_writes_a_trace_and_refuses_overlap(tmp_path):
    from sheeprl_tpu_torch.flock import wire
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.telemetry.trace import TRACE_FILE, profile_window

    window = profile_window()
    server, telem, address = _server(tmp_path)
    try:
        with ServeClient(address) as client:
            reply = client.profile(seconds=0.5)
            assert reply["ok"] and reply["seconds"] == 0.5 and reply["pid"] == os.getpid()
            assert reply["dir"].startswith(os.path.join(str(tmp_path), "profile_ondemand", "window_"))
            assert reply["trace"] == os.path.join(reply["dir"], TRACE_FILE) and reply["cuda"] is False
            client.request({"obs": np.ones((1, OBS_DIM), np.float32)})  # inside the window
            again = client.profile(seconds=0.5)
            assert not again["ok"] and again["error"] == "profile window already open"
            assert again["dir"] == reply["dir"]
            # a bare connection: PROFILE as its first frame, no HELLO
            sock = wire.connect(address, timeout=10)
            wire.send_json(sock, wire.PROFILE, {"seconds": 1})
            bare = wire.recv_json(sock, wire.PROFILE)
            sock.close()
            assert not bare["ok"] and "already open" in bare["error"]
            _wait_closed(window)
            own = client.profile(seconds=0.05, out_dir=str(tmp_path / "elsewhere"))
            assert own["ok"] and own["dir"].startswith(str(tmp_path / "elsewhere"))
            _wait_closed(window)
    finally:
        server.close()
        telem.close()
    with open(reply["trace"]) as fh:
        assert "traceEvents" in json.load(fh)
    assert os.path.exists(own["trace"])
    records = _records(str(tmp_path))
    starts = [r for r in records if r.get("event") == "profile.window.start"]
    stops = [r for r in records if r.get("event") == "profile.window.stop"]
    assert [r["dir"] for r in starts] == [r["dir"] for r in stops] == [reply["dir"], own["dir"]]
    assert all(r["error"] is None for r in stops)


def test_profile_window_refuses_beside_another_profiler(tmp_path):
    from sheeprl_tpu_torch.telemetry.trace import handle_profile_frame, profile_window

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        torch.ones(3).sum()
        reply = handle_profile_frame({"seconds": 0.05}, str(tmp_path))
        assert not reply["ok"] and "another profiler" in reply["error"]
    assert not profile_window().active
    reply = handle_profile_frame({"seconds": 5.0}, str(tmp_path))
    assert reply["ok"]
    profile_window().close()  # an early close stops the window and writes its trace
    assert not profile_window().active and os.path.exists(reply["trace"])


def test_sigusr2_opens_a_window(tmp_path):
    import signal

    from sheeprl_tpu_torch.telemetry.trace import install_profile_signal, profile_window

    previous = signal.getsignal(signal.SIGUSR2)
    try:
        assert install_profile_signal(str(tmp_path), seconds=0.05)
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 10
        while not os.path.isdir(os.path.join(str(tmp_path), "profile_ondemand")) and time.monotonic() < deadline:
            time.sleep(0.01)
        _wait_closed(profile_window())
    finally:
        signal.signal(signal.SIGUSR2, previous)
    (window,) = os.listdir(os.path.join(str(tmp_path), "profile_ondemand"))
    assert os.path.exists(os.path.join(str(tmp_path), "profile_ondemand", window, "trace.json"))
    # off the main thread no handler can be installed
    out: list = []
    t = threading.Thread(target=lambda: out.append(install_profile_signal(str(tmp_path))))
    t.start()
    t.join()
    assert out == [False]


def test_dead_connection_is_reported_with_its_last_request(tmp_path):
    from sheeprl_tpu_torch.flock import wire
    from sheeprl_tpu_torch.serve.server import pack_request, unpack_request

    server, telem, address = _server(tmp_path)
    try:
        sock = wire.connect(address, timeout=10)
        wire.send_json(sock, wire.HELLO, {"proto": 1})
        wire.recv_json(sock, wire.WELCOME)
        wire.send_frame(sock, wire.REQUEST, pack_request({"id": "r-7", "span": "0000beef"},
                                                         {"obs": np.zeros((1, OBS_DIM), np.float32)}))
        _, reply = wire.recv_frame(sock)
        span = unpack_request(reply)[0]["span"]
        sock.sendall(b"XXXX" + bytes(12))  # a corrupt header
        deadline = time.monotonic() + 10
        errors = []
        while not errors and time.monotonic() < deadline:
            errors = [r for r in _records(str(tmp_path)) if r.get("event") == "serve.conn_error"]
            time.sleep(0.02)
        sock.close()
    finally:
        server.close()
        telem.close()
    (err,) = errors
    assert err["request_id"] == "r-7" and err["span"] == span and "magic" in err["error"]
