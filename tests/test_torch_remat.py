"""`--remat` (`ops/scan.py:checkpoint_body`, `compile/decisions.py`) against
the reference's, at the tiny size of `tests/test_torch_dv3_train.py`.

- One whole DreamerV3 gradient step with `--remat off`, `on` and `policy`
  on the CPU from the same state, batch and draws: the three give the
  same metrics and parameters bit for bit (a checkpointed step recomputes
  the same operations on the same inputs), and each is within
  `test_torch_dv3_train.py`'s tolerances of the reference's step with the
  same mode (metrics rtol 1e-3, atol 1e-4; parameters 2*lr + 1e-6).
- A continuous actor's step too (its gradient runs back through the
  checkpointed imagination steps): the three modes bit for bit.
- `decide_remat`'s winner from injected byte and time measurements follows
  the reference's rules (`_pick_winner` of both packages on the same
  reports): a remat rung wins only on strictly fewer peak bytes, within
  `max_time_cost_frac` of the baseline's time, and bit-exact; without a
  peak (the CPU) the baseline stays. `maybe_decide_remat` settles `auto`
  on the CPU with all three rungs' gradients bit-exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dv3_train import (
    CNN_KEYS, KEY_SEED, MLP_KEYS, TINY, VECTOR, A, _batch, _noise, _port_state,
)
from tests.test_torch_interop import jax_flat

MODES = ("off", "on", "policy")


@pytest.fixture(scope="module")
def reference_steps():
    """{mode: (state before, state after, metrics)}: the reference's step
    with each `--remat` mode from the same initial state."""
    import gymnasium as gym

    from sheeprl_tpu import ops
    from sheeprl_tpu.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import DV3TrainState, make_optimizers, make_train_step

    out = {}
    for mode in MODES:
        args = DreamerV3Args(**TINY, remat=mode)
        space = {
            "rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8),
            "state": gym.spaces.Box(-np.inf, np.inf, (VECTOR,), np.float32),
        }
        wm, actor, critic, target = build_models(jax.random.PRNGKey(0), [A], False, args, space, CNN_KEYS,
                                                 MLP_KEYS)
        wopt, aopt, copt = make_optimizers(args)
        state = DV3TrainState(
            world_model=wm, actor=actor, critic=critic, target_critic=target,
            world_opt=wopt.init(wm), actor_opt=aopt.init(actor), critic_opt=copt.init(critic),
            moments=ops.Moments.init(args.moments_decay, args.moment_max, args.moments_percentile_low,
                                     args.moments_percentile_high),
        )
        before = {n: jax_flat(getattr(state, n)) for n in ("world_model", "actor", "critic", "target_critic")}
        step = make_train_step(args, wopt, aopt, copt, CNN_KEYS, MLP_KEYS, [A], False)
        data = {k: jnp.asarray(v) for k, v in _batch().items()}
        new_state, metrics = step(jax.tree_util.tree_map(jnp.copy, state), data, jax.random.PRNGKey(KEY_SEED),
                                  jnp.float32(1.0))
        after = {n: jax_flat(getattr(new_state, n)) for n in before}
        out[mode] = (before, after, {k: float(v) for k, v in metrics.items()})
    return out


def _port_step(before, mode: str):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import make_train_step

    args, state = _port_state(before)
    args.remat = mode
    step = make_train_step(args, CNN_KEYS, MLP_KEYS, [A], False)
    data = {k: torch.from_numpy(v) for k, v in _batch().items()}
    metrics = step(state, data, 1.0, _noise(jax.random.PRNGKey(KEY_SEED)))
    return args, state, metrics


@pytest.mark.timeout(900)
def test_remat_modes_agree_bit_for_bit_and_each_matches_the_reference(reference_steps):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRICS
    from sheeprl_tpu_torch.interop import state_dict_from_jax

    before = reference_steps["off"][0]
    results = {mode: _port_step(before, mode) for mode in MODES}
    _, base_state, base_metrics = results["off"]
    for mode in ("on", "policy"):
        _, state, metrics = results[mode]
        assert metrics == base_metrics, mode
        for name in ("world_model", "actor", "critic", "target_critic"):
            got, want = getattr(state, name).state_dict(), getattr(base_state, name).state_dict()
            assert all(torch.equal(got[p], want[p]) for p in got), (mode, name)
    for mode in MODES:
        ref_before, ref_after, ref_metrics = reference_steps[mode]
        for name in ref_before:  # the reference's modes start from one state
            for a, b in zip(jax.tree_util.tree_leaves(ref_before[name]), jax.tree_util.tree_leaves(before[name])):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        args, state, metrics = results[mode]
        for name in METRICS:
            np.testing.assert_allclose(metrics[name], ref_metrics[name], rtol=1e-3, atol=1e-4, err_msg=f"{mode} {name}")
        lrs = {"world_model": args.world_lr, "actor": args.actor_lr, "critic": args.critic_lr}
        for name in ("world_model", "actor", "critic", "target_critic"):
            module = getattr(state, name)
            atol = 2 * lrs[name] + 1e-6 if name in lrs else 1e-6
            want = state_dict_from_jax(module, ref_after[name])
            for path, value in module.state_dict().items():
                np.testing.assert_allclose(value.numpy(), want[path].numpy(), rtol=0, atol=atol,
                                           err_msg=f"{mode} {name}.{path}")


def test_continuous_step_is_bit_exact_under_every_mode():
    """A continuous actor's loss differentiates through the imagined steps,
    so its gradient runs through `checkpoint_body`'s recomputation."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
        DV3TrainState, draw_noise, make_optimizers, make_train_step,
    )
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.ops.moments import Moments

    batch = _batch()
    data = {k: torch.from_numpy(v) for k, v in batch.items() if k != "state"}
    data["actions"] = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (4, 2, 2)).astype(np.float32))
    results = []
    for mode in MODES:
        args = DreamerV3Args(**TINY, remat=mode, hafner_initialization=False)
        wm, actor, critic, target = build_models(torch.Generator().manual_seed(2), [2], True, args,
                                                 {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}, CNN_KEYS, [])
        state = DV3TrainState(wm, actor, critic, target, *make_optimizers(args, wm, actor, critic),
                              Moments(args.moments_decay, args.moment_max, args.moments_percentile_low,
                                      args.moments_percentile_high))
        noise = draw_noise(args, 4, 2, [2], torch.Generator().manual_seed(3), "cpu", True)
        metrics = make_train_step(args, CNN_KEYS, [], [2], True)(state, data, 1.0, noise)
        results.append((metrics, [p.detach().clone() for m in (wm, actor, critic) for p in m.parameters()]))
    (m0, p0), *rest = results
    assert m0["Grads/actor"] > 0
    for m, p in rest:
        assert m == m0 and all(torch.equal(a, b) for a, b in zip(p, p0))


@pytest.mark.parametrize("value", [True, False, "on", "ON", "policy", "auto", "off", "junk", "1"])
def test_remat_mode_reads_the_flag_as_the_reference(value):
    from sheeprl_tpu.compile.decisions import remat_mode as ref_mode
    from sheeprl_tpu_torch.compile.decisions import remat_mode

    assert remat_mode(value) == ref_mode(value)


# (exec seconds, peak bytes, bit-exact) for off, policy, on
CASES = {
    "policy_cuts_bytes_within_time": {"off": (1.0, 100, True), "policy": (1.02, 80, True), "on": (1.3, 60, True)},
    "on_cuts_most_within_time": {"off": (1.0, 100, True), "policy": (1.01, 80, True), "on": (1.04, 60, True)},
    "only_slow_rungs_cut": {"off": (1.0, 100, True), "policy": (1.2, 80, True), "on": (1.3, 60, True)},
    "equal_bytes_keep_the_baseline": {"off": (1.0, 100, True), "policy": (1.0, 100, True), "on": (1.0, 100, True)},
    "a_rung_not_bit_exact_loses": {"off": (1.0, 100, True), "policy": (1.0, 50, False), "on": (1.01, 70, True)},
    "no_peak_keeps_the_baseline": {"off": (1.0, None, True), "policy": (1.0, None, True), "on": (1.0, None, True)},
    "faster_and_smaller": {"off": (1.0, 100, True), "policy": (0.9, 90, True), "on": (0.95, 95, True)},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("frac", [0.05, None])
def test_remat_winner_follows_the_reference_rules(case, frac):
    from sheeprl_tpu.compile import decisions as ref
    from sheeprl_tpu_torch.compile import decisions as port

    labels = list(port.REMAT_LADDER)
    assert labels == list(ref.REMAT_LADDER)

    def reports(mod):
        return {lbl: mod.CandidateReport(label=lbl, exec_seconds=t, peak_bytes=b, bit_exact=ok)
                for lbl, (t, b, ok) in CASES[case].items()}

    got = port._pick_winner(labels, reports(port), "bytes", "off", frac)
    assert got == ref._pick_winner(labels, reports(ref), "bytes", "off", frac)
    want = {"policy_cuts_bytes_within_time": "policy", "on_cuts_most_within_time": "on",
            "only_slow_rungs_cut": "off", "equal_bytes_keep_the_baseline": "off",
            "a_rung_not_bit_exact_loses": "on", "no_peak_keeps_the_baseline": "off", "faster_and_smaller": "policy"}
    if frac is not None:
        assert got == want[case]
    assert port.DEFAULT_REMAT_TIME_COST_FRAC == ref.DEFAULT_REMAT_TIME_COST_FRAC


def test_decide_remat_on_the_cpu_keeps_off_with_bit_exact_rungs(tmp_path, monkeypatch):
    """`--remat auto` on the CPU: the probe (the RSSM scan's gradient) runs
    under each mode, every rung's gradients equal the baseline's, and with
    no device peak to compare the baseline stays; `args.remat` is settled
    and the decision is stored."""
    from sheeprl_tpu_torch.algos.dreamer_v2.utils import maybe_decide_remat
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.compile import decisions as dec
    from sheeprl_tpu_torch.envs import spaces

    monkeypatch.setenv("SHEEPRL_TPU_REMAT_TIME_COST_FRAC", "0.5")
    assert dec.remat_time_cost_frac() == 0.5
    args = DreamerV3Args(**TINY, remat="auto")
    wm, _, _, _ = build_models(torch.Generator().manual_seed(0), [A], False, args,
                               {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}, CNN_KEYS, [])
    store = str(tmp_path / "decisions.json")
    decision = maybe_decide_remat("dreamer_v3", wm, args, A, store_path=store)
    assert decision.winner == args.remat == "off" and not decision.accepted and decision.objective == "bytes"
    assert decision.max_time_cost_frac == 0.5
    assert all(decision.candidate(m)["bit_exact"] for m in dec.REMAT_LADDER)
    assert all(decision.candidate(m)["peak_bytes"] is None for m in dec.REMAT_LADDER)
    args.remat = "auto"
    assert maybe_decide_remat("dreamer_v3", wm, args, A, store_path=store).source == "cache"
    args.remat = "on"
    assert maybe_decide_remat("dreamer_v3", wm, args, A, store_path=store) is None and args.remat == "on"
