"""Checkpoint, resume and `serve --ckpt` of the port (`utils/checkpoint.py`,
`algos/dreamer_v3/dreamer_v3.py:main`, `serve/policies.py`) on the CPU, at
tiny widths, and against the reference where a reference checkpoint is the
input:

  - the reference's DreamerV3 `main` writes a checkpoint and its buffer
    sidecar (`--checkpoint_every 1 --checkpoint_buffer`, the argv of
    tests/test_algos/test_dreamer_v3.py); `interop.py` carries it into the
    port's format; every parameter and Adam moment arrives bit for bit;
    one gradient step from the restored state in each package, the
    reference's Gumbel draws fed to both (the harness of
    tests/test_torch_dv3_train.py), agrees at that test's tolerances: this
    is what a wrong `count` -> `step` or `mu` / `nu` mapping would break;
    the buffer sidecar loads into the port's `AsyncReplayBuffer` with
    the same rows;
  - the port's own round trip: save -> load is bit-exact and a step after
    it equals a step without it; `main --checkpoint_path` resumes at
    `global_step + 1`, shifts `learning_starts` when no buffer was saved
    and takes tau 1 at its first gradient step (the reference's counter
    restarts at 0); a checkpoint without its commit marker or its sidecar
    is skipped and refused;
  - serving: `serve --device cpu --ckpt` answers as a direct
    `PlayerDV3.step` of the loaded params, a RELOAD moves the answers to a
    second checkpoint, a RELOAD to a broken one keeps the version and
    counts a failure; SAC `--quant int8 --ckpt`, from a checkpoint
    converted from the reference's `sac` main, reads the persisted scales
    at version 1 and re-derives them on a reload.

Tolerances of the gradient step as in tests/test_torch_dv3_train.py
(metrics rtol 1e-3, atol 1e-4; the target critic, an EMA of the
pre-update critic, 1e-6), parameters tighter than its 2*lr: 0.02*lr + 1e-6
(the reason is at the comparison).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the reference's tiny DreamerV3 (tests/test_algos/test_dreamer_v3.py:12-32)
REF_TINY = [
    "--dry_run", "--num_devices=1", "--num_envs=1", "--sync_env", "--per_rank_batch_size=1",
    "--per_rank_sequence_length=1", "--buffer_size=4", "--learning_starts=0", "--gradient_steps=1",
    "--horizon=4", "--dense_units=8", "--cnn_channels_multiplier=2", "--recurrent_state_size=8",
    "--hidden_size=8", "--stochastic_size=4", "--discrete_size=4", "--mlp_layers=1", "--train_every=1",
    "--checkpoint_every=1",
]
# the port's tiny DreamerV3 run on the CPU (README)
PORT_TINY = [
    "--device", "cpu", "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "1",
    "--cnn_channels_multiplier", "2", "--dense_units", "16", "--hidden_size", "16", "--recurrent_state_size", "16",
    "--stochastic_size", "4", "--discrete_size", "4", "--per_rank_batch_size", "2", "--per_rank_sequence_length",
    "4", "--horizon", "3", "--train_every", "2", "--buffer_size", "64", "--bins", "15",
]
CNN_KEYS = ["rgb"]
KEY_SEED = 7
STEP_T, STEP_B = 4, 2  # the parity step's batch


def _rgb_space():
    from sheeprl_tpu_torch.envs import spaces

    return {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}


# ---------------------------------------------------------------------------
# the reference's checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_dv3(tmp_path_factory):
    """The reference DreamerV3 `main` at its tiny test size on
    discrete_dummy pixels, one gradient step, checkpoint and buffer
    sidecar. -> the checkpoint's path."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import main

    root = tmp_path_factory.mktemp("ref_dv3")
    main(REF_TINY + ["--env_id=discrete_dummy", f"--root_dir={root}", "--run_name=ref", "--cnn_keys", "rgb",
                     "--checkpoint_buffer"])
    return str(root / "ref" / "checkpoints" / "ckpt_1")


def _port_args(ckpt: str, **overrides):
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint_args
    from sheeprl_tpu_torch.utils.parser import DataclassArgumentParser

    (args,) = DataclassArgumentParser(DreamerV3Args).parse_dict(load_checkpoint_args(ckpt))
    return dataclasses.replace(args, **overrides)


def _port_state(args, actions: int, seed: int = 1):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3TrainState, make_optimizers
    from sheeprl_tpu_torch.ops.moments import Moments

    wm, actor, critic, target = build_models(torch.Generator().manual_seed(seed), [actions], False, args,
                                             _rgb_space(), CNN_KEYS, [])
    return DV3TrainState(
        wm, actor, critic, target, *make_optimizers(args, wm, actor, critic),
        Moments(args.moments_decay, args.moment_max, args.moments_percentile_low, args.moments_percentile_high),
    )


def _actions_of(raw) -> int:
    return int(np.asarray(raw["actor"]["heads"][0]["weight"]).shape[1])


def _converted(reference_dv3, tmp_path):
    """The reference checkpoint through `interop.py`, written and read back
    in the port's format. -> (raw reference tree, port args, port path,
    port checkpoint as loaded)."""
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu_torch.interop import dreamer_v3_checkpoint_from_jax
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    raw = ref_load(reference_dv3)
    args = _port_args(reference_dv3)
    converted = dreamer_v3_checkpoint_from_jax(raw, _port_state(args, _actions_of(raw)))
    path = str(tmp_path / "port" / "checkpoints" / "ckpt_1")
    save_checkpoint(path, converted, args)
    return raw, args, path, load_checkpoint(path)


def test_reference_checkpoint_arrives_bit_for_bit(reference_dv3, tmp_path):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import restore_state
    from sheeprl_tpu_torch.interop import flatten_params

    raw, args, _, ckpt = _converted(reference_dv3, tmp_path)
    assert set(ckpt) == {"world_model", "actor", "critic", "target_critic", "world_optimizer", "actor_optimizer",
                         "critic_optimizer", "moments", "expl_decay_steps", "global_step", "batch_size"}
    state = _port_state(args, _actions_of(raw), seed=5)
    restore_state(state, ckpt)
    from sheeprl_tpu_torch.nn.layers import Linear

    for key, opt_key in (("world_model", "world_optimizer"), ("actor", "actor_optimizer"),
                         ("critic", "critic_optimizer"), ("target_critic", None)):
        module = getattr(state, key)
        linear = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, Linear)}
        ref = flatten_params(raw[key])
        params = dict(module.named_parameters())
        assert set(ref) == set(params), key
        for name, p in params.items():
            want = ref[name].T if name in linear else ref[name]
            np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=f"{key}.{name}")
        if opt_key is None:
            continue
        adam = raw[opt_key][1][0]  # (clip's empty state, (ScaleByAdamState, scale's empty state))
        mu, nu = flatten_params(adam["mu"]), flatten_params(adam["nu"])
        opt = {"world_model": state.world_opt, "actor": state.actor_opt, "critic": state.critic_opt}[key]
        for p in params.values():
            name = next(n for n, q in params.items() if q is p)
            st = opt.state[p]
            assert float(st["step"]) == float(adam["count"]) == 1.0
            for side, flat in (("exp_avg", mu), ("exp_avg_sq", nu)):
                want = flat[name].T if name in linear else flat[name]
                np.testing.assert_array_equal(st[side].numpy(), want, err_msg=f"{opt_key}.{side}.{name}")
    assert float(state.moments.low) == float(raw["moments"]["low"])
    assert float(state.moments.high) == float(raw["moments"]["high"])
    assert (ckpt["global_step"], ckpt["expl_decay_steps"], ckpt["batch_size"]) == (
        int(raw["global_step"]), int(raw["expl_decay_steps"]), int(raw["batch_size"]))


def _batch(actions: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    dones = np.zeros((STEP_T, STEP_B, 1), np.float32)
    is_first = np.zeros((STEP_T, STEP_B, 1), np.float32)
    dones[1, 0], is_first[2, 0] = 1.0, 1.0
    return {
        "rgb": rng.integers(0, 255, (STEP_T, STEP_B, 64, 64, 3), dtype=np.uint8),
        "actions": np.eye(actions, dtype=np.float32)[rng.integers(0, actions, (STEP_T, STEP_B))],
        "rewards": rng.normal(size=(STEP_T, STEP_B, 1)).astype(np.float32), "dones": dones, "is_first": is_first,
    }


def _noise(key, actions: int, s: int, d: int, horizon: int) -> dict:
    """The reference step's Gumbel draws rebuilt from its key tree, as in
    tests/test_torch_dv3_train.py:_noise, at this checkpoint's sizes."""
    t, b = STEP_T, STEP_B
    k_wm, k_img = jax.random.split(key)
    post = [jax.random.gumbel(jax.random.split(k)[1], (b, s, d)) for k in jax.random.split(k_wm, t)]
    img_keys = jax.random.split(k_img, horizon + 1)

    def actor_draw(k):
        _, sub = jax.random.split(k)
        return jax.random.gumbel(sub, (t * b, actions))

    prior, acts = [], []
    for h in range(horizon):
        k_act, k_trans = jax.random.split(img_keys[h])
        acts.append(actor_draw(k_act))
        prior.append(jax.random.gumbel(k_trans, (t * b, s, d)))
    acts.append(actor_draw(img_keys[horizon]))
    stack = lambda xs: torch.from_numpy(np.array(jnp.stack(xs)))  # noqa: E731
    return {"post": stack(post), "img_prior": stack(prior), "img_actions": [stack(acts)]}


@pytest.mark.timeout(600)
def test_one_gradient_step_from_a_reference_checkpoint_matches(reference_dv3, tmp_path):
    """The reference restores its checkpoint into its own template and takes
    one step; the port restores the converted checkpoint and takes the same
    step (same batch, the reference's noise, tau 0.02)."""
    from sheeprl_tpu import ops
    from sheeprl_tpu.algos.dreamer_v3.agent import build_models as ref_build
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args as RefArgs
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import DV3TrainState as RefState
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_optimizers as ref_optimizers
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as ref_train_step
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu.utils.checkpoint import load_checkpoint_args as ref_args_of
    from sheeprl_tpu.utils.parser import DataclassArgumentParser as RefParser
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRICS, make_train_step, restore_state
    from sheeprl_tpu_torch.interop import state_dict_from_jax
    from tests.test_torch_interop import jax_flat

    import gymnasium as gym

    raw, _, _, ckpt = _converted(reference_dv3, tmp_path)
    actions = _actions_of(raw)
    tau = 0.02
    # the reference: its own template, as its main builds it (dreamer_v3.py:646-672)
    (jargs,) = RefParser(RefArgs).parse_dict(ref_args_of(reference_dv3))
    jargs = dataclasses.replace(jargs, per_rank_batch_size=STEP_B, per_rank_sequence_length=STEP_T)
    space = {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)}
    wm, actor, critic, target = ref_build(jax.random.PRNGKey(jargs.seed), [actions], False, jargs, space,
                                          CNN_KEYS, [])
    wopt, aopt, copt = ref_optimizers(jargs)
    template = {
        "world_model": wm, "actor": actor, "critic": critic, "target_critic": target,
        "world_optimizer": wopt.init(wm), "actor_optimizer": aopt.init(actor), "critic_optimizer": copt.init(critic),
        "moments": ops.Moments.init(jargs.moments_decay, jargs.moment_max, jargs.moments_percentile_low,
                                    jargs.moments_percentile_high),
        "expl_decay_steps": 0, "global_step": 0, "batch_size": 0,
    }
    r = ref_load(reference_dv3, template)
    ref_state = RefState(world_model=r["world_model"], actor=r["actor"], critic=r["critic"],
                         target_critic=r["target_critic"], world_opt=r["world_optimizer"],
                         actor_opt=r["actor_optimizer"], critic_opt=r["critic_optimizer"], moments=r["moments"])
    step = ref_train_step(jargs, wopt, aopt, copt, CNN_KEYS, [], [actions], False)
    data = {k: jnp.asarray(v) for k, v in _batch(actions).items()}
    new_state, ref_metrics = step(ref_state, data, jax.random.PRNGKey(KEY_SEED), jnp.float32(tau))
    after = {name: jax_flat(getattr(new_state, name)) for name in ("world_model", "actor", "critic",
                                                                    "target_critic")}

    # the port: the converted checkpoint restored into a state of its own
    args = _port_args(reference_dv3, per_rank_batch_size=STEP_B, per_rank_sequence_length=STEP_T)
    state = _port_state(args, actions, seed=9)
    restore_state(state, ckpt)
    port_step = make_train_step(args, CNN_KEYS, [], [actions], False)
    noise = _noise(jax.random.PRNGKey(KEY_SEED), actions, args.stochastic_size, args.discrete_size, args.horizon)
    metrics = port_step(state, {k: torch.from_numpy(v) for k, v in _batch(actions).items()}, tau, noise)

    for name in METRICS:
        np.testing.assert_allclose(metrics[name], float(ref_metrics[name]), rtol=1e-3, atol=1e-4, err_msg=name)
    np.testing.assert_allclose([float(state.moments.low), float(state.moments.high)],
                               [float(new_state.moments.low), float(new_state.moments.high)], rtol=1e-3, atol=1e-5)
    # tests/test_torch_dv3_train.py allows 2*lr, for a first Adam step that
    # is about lr * sign(g); from a restored state (count 1, moments set)
    # no update hangs on the sign of a near-zero gradient, and 0.02*lr holds
    # with room (the largest deviation here is under 0.002*lr); a count or
    # mu / nu mapped wrong moves parameters by about 0.14*lr
    lrs = {"world_model": args.world_lr, "actor": args.actor_lr, "critic": args.critic_lr}
    for name in after:
        module = getattr(state, name)
        atol = 0.02 * lrs[name] + 1e-6 if name in lrs else 1e-6
        want = state_dict_from_jax(module, after[name])
        for path, got in module.state_dict().items():
            np.testing.assert_allclose(got.numpy(), want[path].numpy(), rtol=0, atol=atol, err_msg=f"{name}.{path}")
    # the Adam step counts moved on together from the checkpoint's count
    assert all(float(s["step"]) == 2.0 for s in state.world_opt.state.values())
    assert int(new_state.world_opt[1][0].count) == 2


def test_reference_buffer_sidecar_loads_with_equal_rows(reference_dv3):
    from sheeprl_tpu_torch.data.buffers import AsyncReplayBuffer

    sidecar = reference_dv3 + "_buffer.npz"
    with np.load(sidecar) as z:
        ref = {k: z[k] for k in z.files}
    rb = AsyncReplayBuffer(int(ref["buffer_size"]), int(ref["n_envs"]))
    rb.load(sidecar)
    keys = sorted(k[len("b0_buf_"):] for k in ref if k.startswith("b0_buf_"))
    assert sorted(rb._buf) == keys and "rgb" in keys
    for k in keys:
        np.testing.assert_array_equal(rb._buf[k][:, 0], ref[f"b0_buf_{k}"][:, 0], err_msg=k)
        assert rb._buf[k].dtype == ref[f"b0_buf_{k}"].dtype
    assert int(rb._pos[0]) == int(ref["b0_pos"]) and bool(rb._full[0]) == bool(ref["b0_full"])
    # a sample with injected (env, start) pairs reads the reference's rows
    start = np.array([0])
    got = rb.sample(1, sequence_length=1, indices=(np.array([0]), start))
    for k in keys:
        np.testing.assert_array_equal(got[k][0, 0, 0], ref[f"b0_buf_{k}"][0, 0])


# ---------------------------------------------------------------------------
# the port's own round trip
# ---------------------------------------------------------------------------


def _tiny_args(**kw):
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args

    return DreamerV3Args(cnn_channels_multiplier=2, dense_units=16, recurrent_state_size=16, hidden_size=16,
                         stochastic_size=4, discrete_size=4, per_rank_batch_size=STEP_B,
                         per_rank_sequence_length=STEP_T, horizon=3, bins=15, **kw)


def _flat_equal(a, b, where=""):
    """Every leaf of two checkpoint trees equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _flat_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _flat_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_save_load_is_bit_exact_and_training_goes_on_the_same(tmp_path):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import (
        checkpoint_state, draw_noise, make_train_step, restore_state,
    )
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint, to_host

    args = _tiny_args()
    state = _port_state(args, 2, seed=3)
    step = make_train_step(args, CNN_KEYS, [], [2], False)
    data = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    noise = [draw_noise(args, STEP_T, STEP_B, [2], torch.Generator().manual_seed(i), "cpu") for i in range(2)]
    step(state, data, 1.0, noise[0])
    saved = to_host(checkpoint_state(state, 3, 17, STEP_B))
    path = str(tmp_path / "checkpoints" / "ckpt_17")
    nbytes = save_checkpoint(path, checkpoint_state(state, 3, 17, STEP_B), args)
    assert nbytes == os.path.getsize(os.path.join(path, "state.pt")) > 0
    loaded = load_checkpoint(path)
    _flat_equal(saved, loaded)
    fresh = _port_state(args, 2, seed=11)
    restore_state(fresh, loaded)
    _flat_equal(saved, to_host(checkpoint_state(fresh, 3, 17, STEP_B)))
    # the next step from the restored state is the next step from the live one
    m_live = step(state, data, 0.02, noise[1])
    m_restored = step(fresh, data, 0.02, noise[1])
    assert m_live == m_restored
    _flat_equal(to_host(checkpoint_state(state, 3, 17, STEP_B)), to_host(checkpoint_state(fresh, 3, 17, STEP_B)))


def _run_main(argv, monkeypatch=None):
    """The port's `main` in this process; with `monkeypatch`, the tau of
    every gradient step is recorded. -> (taus, records, done)."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3

    taus: list[float] = []
    if monkeypatch is not None:
        real = dv3.make_train_step

        def spy(*a, **k):
            step = real(*a, **k)

            def recorded(state, data, tau, noise):
                taus.append(tau)
                return step(state, data, tau, noise)

            return recorded

        monkeypatch.setattr(dv3, "make_train_step", spy)
    dv3.main(argv)
    if monkeypatch is not None:
        monkeypatch.undo()
    return taus


def _runs(run_dir):
    """metrics.jsonl split into runs (a resumed run appends to it): ->
    [(training records, done record), ...]. The records of a run's test
    episodes (`Test/*`) are left out."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh if line.strip()]
    runs, current = [], []
    for r in records:
        if r.get("event") == "done":
            runs.append((current, r))
            current = []
        elif "gradient_steps" in r:
            current.append(r)
    return runs


@pytest.mark.timeout(300)
def test_resume_starts_after_the_checkpoint_shifts_learning_starts_and_takes_tau_1(tmp_path, monkeypatch):
    """Without a buffer the resumed run collects afresh: `learning_starts`
    moves past the restart (8 + 9 = 17), and its first gradient step takes
    tau 1 (the counter restarts at 0, as in the reference)."""
    from sheeprl_tpu_torch.utils.checkpoint import latest_checkpoint, list_checkpoints, load_checkpoint

    run_dir = str(tmp_path / "r")
    argv = PORT_TINY + ["--root_dir", str(tmp_path), "--run_name", "r", "--learning_starts", "8",
                        "--total_steps", "24", "--checkpoint_every", "8"]
    first_taus = _run_main(argv, monkeypatch)
    assert first_taus[0] == 1.0 and set(first_taus[1:]) == {0.02}
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    assert [os.path.basename(p) for p in list_checkpoints(ckpt_dir)] == ["ckpt_24", "ckpt_16", "ckpt_8"]
    assert not os.path.exists(os.path.join(ckpt_dir, "ckpt_8_buffer.npz"))
    ckpt8 = load_checkpoint(os.path.join(ckpt_dir, "ckpt_8"))
    assert ckpt8["global_step"] == 8 and ckpt8["batch_size"] == STEP_B
    assert latest_checkpoint(ckpt_dir).endswith("ckpt_24")

    taus = _run_main(["--checkpoint_path", os.path.join(ckpt_dir, "ckpt_8")], monkeypatch)
    (_, done_first), (train, done) = _runs(run_dir)  # the resumed run wrote on in the same run directory
    assert done_first["resumed"] is None
    resumed = done["resumed"]
    assert resumed["start_step"] == 9 and resumed["learning_starts"] == 8 + 9 and "buffer" not in resumed
    assert done["env_steps"] == 24 - 8 and train[0]["step"] == 17
    assert taus[0] == 1.0 and set(taus[1:]) == {0.02} and len(taus) == done["gradient_steps"] > 1
    assert [c["step"] for c in done["checkpoints"]] == [16, 24]


@pytest.mark.timeout(300)
def test_resume_with_its_buffer_keeps_learning_starts_and_the_rows(tmp_path):
    from sheeprl_tpu_torch.data.buffers import AsyncReplayBuffer

    run_dir = str(tmp_path / "r")
    argv = PORT_TINY + ["--root_dir", str(tmp_path), "--run_name", "r", "--learning_starts", "16",
                        "--total_steps", "24", "--checkpoint_every", "4", "--checkpoint_buffer"]
    _run_main(argv)
    ckpt = os.path.join(run_dir, "checkpoints", "ckpt_20")
    rb = AsyncReplayBuffer(64, 1)
    rb.load(ckpt + "_buffer.npz")
    assert int(rb._pos[0]) >= 20 and not rb._full[0]  # a row a step, and a reset row at each episode's end
    _run_main(["--checkpoint_path", ckpt])
    (_, _), (train, done) = _runs(run_dir)
    resumed = done["resumed"]
    assert resumed["start_step"] == 21 and resumed["learning_starts"] == 16
    assert resumed["buffer"] == os.path.abspath(ckpt + "_buffer.npz")
    assert done["gradient_steps"] == 2 and [r["step"] for r in train] == [22, 24]


def test_invalid_checkpoints_are_skipped_and_refused(tmp_path):
    from sheeprl_tpu_torch.utils.checkpoint import (
        COMMIT_MARKER, latest_checkpoint, list_checkpoints, load_checkpoint, save_checkpoint, valid_checkpoint,
    )

    d = tmp_path / "checkpoints"
    for step in (1, 2, 3):
        save_checkpoint(str(d / f"ckpt_{step}"), {"global_step": step, "w": torch.ones(2)}, {"seed": step})
    os.remove(d / "ckpt_3" / COMMIT_MARKER)  # an interrupted write
    os.remove(d / "ckpt_2.args.json")  # a lost sidecar
    assert valid_checkpoint(str(d / "ckpt_3")) == (False, f"missing commit marker {COMMIT_MARKER}")
    assert valid_checkpoint(str(d / "ckpt_2")) == (False, "missing args.json sidecar")
    assert valid_checkpoint(str(d / "ckpt_1")) == (True, "")
    assert list_checkpoints(str(d)) == [str(d / "ckpt_1")]
    assert latest_checkpoint(str(d)) == str(d / "ckpt_1")
    assert latest_checkpoint(str(tmp_path / "absent")) is None and list_checkpoints(str(tmp_path / "absent")) == []
    with pytest.raises(FileNotFoundError, match="not a committed checkpoint"):
        load_checkpoint(str(d / "ckpt_3"))
    # a save over an existing checkpoint replaces it whole
    save_checkpoint(str(d / "ckpt_1"), {"global_step": 9}, {"seed": 9})
    assert load_checkpoint(str(d / "ckpt_1")) == {"global_step": 9}
    assert sorted(os.listdir(d)) == ["ckpt_1", "ckpt_1.args.json", "ckpt_2", "ckpt_3", "ckpt_3.args.json"]


# ---------------------------------------------------------------------------
# serve --ckpt
# ---------------------------------------------------------------------------


def _serve(argv, run_dir):
    """Start `serve` (argv after the task name) in a thread. -> (address,
    thread, errors)."""
    from sheeprl_tpu_torch.cli import run

    errors: list[BaseException] = []

    def _run():
        try:
            run(["serve", *argv])
        except BaseException as err:  # surfaced by the callers' assertions
            errors.append(err)

    thread = threading.Thread(target=_run, daemon=True)
    thread.start()
    addr_file = os.path.join(run_dir, "serve_address")
    deadline = time.monotonic() + 60
    while not os.path.exists(addr_file) and not errors and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not errors, errors
    return open(addr_file).read().strip(), thread, errors


def _telemetry(run_dir):
    with open(os.path.join(run_dir, "telemetry.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A tiny port run with checkpoints at steps 20 and 24. -> its
    checkpoint directory."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main

    root = tmp_path_factory.mktemp("port_dv3")
    main(PORT_TINY + ["--root_dir", str(root), "--run_name", "r", "--learning_starts", "16", "--total_steps",
                      "24", "--checkpoint_every", "4"])
    return str(root / "r" / "checkpoints")


@pytest.mark.timeout(120)
def test_serve_dv3_ckpt_answers_as_the_loaded_player_and_reloads(port_run, tmp_path):
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.policies import build_policy
    from sheeprl_tpu_torch.utils.checkpoint import COMMIT_MARKER

    first, second = os.path.join(port_run, "ckpt_20"), os.path.join(port_run, "ckpt_24")
    broken = str(tmp_path / "checkpoints" / "ckpt_99")
    shutil.copytree(second, broken)
    shutil.copy(second + ".args.json", broken + ".args.json")
    os.remove(os.path.join(broken, COMMIT_MARKER))
    rng = np.random.default_rng(0)
    obs = [rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8) for _ in range(7)]
    run_dir = str(tmp_path / "s")
    address, thread, errors = _serve(
        ["--device", "cpu", "--ckpt", first, "--model_argv", "--cnn_channels_multiplier 4", "--root_dir",
         str(tmp_path), "--run_name", "s", "--serve_requests", "7", "--deadline_ms", "0"], run_dir)
    with ServeClient(address) as client:
        before = [client.request({"rgb": o}, session="a")[0]["actions"] for o in obs[:3]]
        reply = client.reload(second)
        assert reply["ok"] and reply["version"] == 2, reply
        after = [client.request({"rgb": o}, session="b")[0]["actions"] for o in obs[3:6]]
        bad = client.reload(broken)
        assert not bad["ok"] and bad["version"] == 2 and "not a committed checkpoint" in bad["error"]
        last = client.request({"rgb": obs[6]}, session="b")[0]["actions"]
    thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors

    # the served model is the checkpoint's (its sidecar's widths, not --model_argv's)
    policy, player, loader = build_policy(ServeArgs(device="cpu", ckpt=first), torch.device("cpu"))
    players = (player, loader(second))
    assert not torch.equal(players[0].actor.heads[0].weight, players[1].actor.heads[0].weight)
    for p, steps, answers in ((players[0], obs[:3], before), (players[1], obs[3:], after + [last])):
        init = policy.init_row(id(p), p)
        state = {k: v[None] for k, v in init.items()}
        for o, got in zip(steps, answers):
            with torch.inference_mode():
                state, acts = policy.step(p, state, {"rgb": torch.from_numpy(o)})
            np.testing.assert_array_equal(got, acts.numpy())
    gauges = [r for r in _telemetry(run_dir) if r.get("event") == "interval"][-1]["metrics"]
    assert gauges["Serve/params_version"] == 2.0 and gauges["Serve/reloads"] == 1.0
    assert gauges["Serve/reload_failures"] == 1.0


@pytest.fixture(scope="module")
def reference_sac(tmp_path_factory):
    """The reference SAC `main` at its tiny test size (Pendulum-v1, hidden
    8): one dry-run step and its checkpoint. -> the checkpoint's path."""
    import sheeprl_tpu.algos  # noqa: F401 - registers the tasks
    from sheeprl_tpu.utils.registry import tasks

    root = tmp_path_factory.mktemp("ref_sac")
    tasks["sac"](["--env_id", "Pendulum-v1", "--dry_run", "--num_envs", "1", "--per_rank_batch_size", "2",
                  "--buffer_size", "4", "--learning_starts", "0", "--gradient_steps", "1", "--actor_hidden_size",
                  "8", "--critic_hidden_size", "8", "--root_dir", str(root), "--run_name", "ref"])
    return str(root / "ref" / "checkpoints" / "ckpt_1")


@pytest.mark.timeout(300)
def test_serve_sac_int8_ckpt_reads_persisted_scales_then_rederives_on_reload(reference_sac, tmp_path,
                                                                              monkeypatch):
    """A SAC checkpoint converted from the reference's `sac` main is served
    with `--quant int8`: version 1 quantizes with the scales persisted
    beside the checkpoint (calibrated here from another seed, so they differ
    from a fresh calibration), a RELOAD re-derives them for the new params
    in the reload hook and persists them, and every answer equals the
    direct int8 step of its version. int8 is made to win every rung's
    timing, as it does on the card (on the CPU its plain trunk is slower)."""
    import sheeprl_tpu_torch.compile.decisions as decisions
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu.utils.checkpoint import load_checkpoint_args as ref_args_of
    from sheeprl_tpu_torch.algos.sac.agent import SACActor, SACAgent
    from sheeprl_tpu_torch.algos.sac.args import SACArgs
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainState, make_optimizers
    from sheeprl_tpu_torch.interop import flatten_params, sac_checkpoint_from_jax
    from sheeprl_tpu_torch.ops import quant as q
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.quant import QuantState, _make_fused_sac_step
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    raw = ref_load(reference_sac)
    sidecar = ref_args_of(reference_sac)
    hidden = sidecar["actor_hidden_size"]
    agent = SACAgent(3, 1, num_critics=sidecar["num_critics"], actor_hidden_size=hidden,
                     critic_hidden_size=sidecar["critic_hidden_size"], action_low=-2.0, action_high=2.0)
    converted = sac_checkpoint_from_jax(raw, SACTrainState(agent, *make_optimizers(SACArgs(), agent)))
    actor = agent.actor
    actor.load_state_dict(converted["agent"]["actor"])
    ref_actor = flatten_params(raw["agent"]["actor"])
    np.testing.assert_array_equal(actor.model.layers[0].weight.detach().numpy(), ref_actor["model.layers.0.weight"].T)
    assert set(converted) == {"agent", "qf_optimizer", "actor_optimizer", "alpha_optimizer", "global_step",
                              "generator"}
    assert set(converted["agent"]) == {"actor", "critics", "target_critics", "log_alpha"}
    first = str(tmp_path / "checkpoints" / "ckpt_1")
    save_checkpoint(first, converted, sidecar)
    assert torch.equal(load_checkpoint(first)["agent"]["critics"]["members.model.head.weight"],
                       torch.from_numpy(np.asarray(raw["agent"]["critics"]["members"]["model"]["head"]["weight"])))
    moved = load_checkpoint(first)
    moved["agent"]["actor"] = {k: v * 1.5 if k.endswith("weight") else v for k, v in moved["agent"]["actor"].items()}
    second = str(tmp_path / "checkpoints" / "ckpt_2")
    save_checkpoint(second, moved, sidecar)
    actor2 = SACActor(3, 1, hidden_size=hidden, action_low=-2.0, action_high=2.0)
    actor2.load_state_dict(moved["agent"]["actor"])

    policy_ns = types.SimpleNamespace(algo="sac", obs_dim=3, device=torch.device("cpu"),
                                      step=lambda a, x: a.get_greedy_actions(x))
    seed = sidecar["seed"]
    other = QuantState(policy_ns, types.SimpleNamespace(quant_bound=1.0, seed=seed + 100, ckpt=None),
                       str(tmp_path / "other"))._calibrate(1, actor)
    q.save_scales(q.scales_path(first), other)

    real_decide = decisions.decide

    def int8_wins(*a, **k):
        d = real_decide(*a, **k)
        if d.candidate("int8").get("within_bound"):
            d.winner = "int8"
        return d

    monkeypatch.setattr(decisions, "decide", int8_wins)
    run_dir = str(tmp_path / "s")
    rng = np.random.default_rng(1)
    obs = [rng.standard_normal((1, 3)).astype(np.float32) for _ in range(4)]
    address, thread, errors = _serve(
        ["--device", "cpu", "--algo", "sac", "--quant", "int8", "--quant_bound", "1.0", "--ckpt", first,
         "--max_batch", "2", "--root_dir", str(tmp_path), "--run_name", "s", "--serve_requests", "4",
         "--deadline_ms", "0"], run_dir)
    with ServeClient(address) as client:
        answers = [client.request({"obs": o}) for o in obs[:2]]
        reply = client.reload(second)
        assert reply["ok"] and reply["version"] == 2, reply
        answers += [client.request({"obs": o}) for o in obs[2:]]
    thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors

    records = _telemetry(run_dir)
    start = next(r for r in records if r.get("event") == "serve.start")
    assert start["int8_rungs"] == [1, 2]
    sources = [(r["source"], r["version"]) for r in records if r.get("event") == "serve.quant_scales"]
    assert sources == [("persisted", 1), ("calibrated", 2)]
    gauges = [r for r in records if r.get("event") == "interval"][-1]["metrics"]
    assert gauges["Serve/quant_rederives"] == 1.0 and gauges["Serve/params_version"] == 2.0
    fresh2 = QuantState(policy_ns, types.SimpleNamespace(quant_bound=1.0, seed=seed, ckpt=None),
                        str(tmp_path / "d2"))._calibrate(2, actor2)
    persisted = q.load_scales(q.scales_path(first))
    assert sorted(persisted) == sorted(fresh2)
    for k in fresh2:  # the re-derived scales were written after the derivation
        np.testing.assert_array_equal(persisted[k], fresh2[k])
    fused = _make_fused_sac_step()
    for (res, meta), o, (a, scales) in zip(answers, obs, [(actor, other)] * 2 + [(actor2, fresh2)] * 2):
        assert meta["rung"] == 1
        with torch.inference_mode():
            want = fused(q.quantize_linears(a, scales), torch.from_numpy(o))
        np.testing.assert_array_equal(res["actions"], want.numpy())
