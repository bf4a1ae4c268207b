"""DreamerV1 in the port against the reference, at a tiny size (cnn
multiplier 2, dense 16, a 4-wide Gaussian state, T=4, B=2, horizon 3, 64x64
rgb plus one vector key): `GRUCell`, `kl_normal`, the Gaussian RSSM's scan,
the player's step, one whole gradient step with 2 continuous actions (the
tanh-normal actor trained through imagination) and with 3 discrete ones, a
reference checkpoint carried across, the guards (no kernel on the path),
and the entry point end to end on the CPU.

Parameters come from the reference through `interop`. The Gaussian states'
draws are the reference's own normals, rebuilt from its key tree; the
tanh-normal actor's draws are the floats under the reference's
`jax.random.normal`, which the port maps as JAX does
(`ops/distributions.py:standard_normal`, equal to JAX's to a few ulps of
its slope). Tolerances: the cell, the KL, the scan and the greedy player
step f32 at rtol 1e-5 (atol 1e-5 near zero); where the mapped normals
enter (the sampled player step), atol 1e-4; the gradient step as in
`tests/test_torch_dv3_train.py`.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dreamer_v2 import _batch, _check_step, _close, _spaces, _spy_kernels, _t
from tests.test_torch_interop import jax_flat

TINY = dict(
    cnn_channels_multiplier=2, dense_units=16, recurrent_state_size=16, hidden_size=16, stochastic_size=4,
    mlp_layers=2, per_rank_batch_size=2, per_rank_sequence_length=4, horizon=3,
)
T, B, S, H, R = 4, 2, 4, 3, 16
CNN_KEYS, MLP_KEYS = ["rgb"], ["state"]
KEY_SEED = 7


def test_gru_cell_matches_the_reference():
    """The textbook GRU on the port's Linears: the two projections carried
    across (transposed) and one step at f32."""
    from sheeprl_tpu.nn.recurrent import GRUCell as RefGRU
    from sheeprl_tpu_torch.interop import load_jax_params
    from sheeprl_tpu_torch.nn.recurrent import GRUCell

    ref = RefGRU.init(jax.random.PRNGKey(0), 7, 12)
    port = load_jax_params(GRUCell(7, 12), jax_flat(ref))
    rng = np.random.default_rng(0)
    x, h = rng.normal(size=(5, 7)).astype(np.float32), rng.normal(size=(5, 12)).astype(np.float32)
    _close(port(_t(x), _t(h)), ref(jnp.asarray(x), jnp.asarray(h)), "gru")


def test_kl_normal_matches_the_reference():
    from sheeprl_tpu.ops import distributions as R
    from sheeprl_tpu_torch.ops import distributions as P

    rng = np.random.default_rng(1)
    loc_p, loc_q = rng.normal(size=(2, 6, 5)).astype(np.float32)
    sc_p, sc_q = (np.abs(rng.normal(size=(2, 6, 5))) + 0.1).astype(np.float32)
    for ndims in (0, 1, 2):
        want = R.kl_normal(R.Normal(loc=jnp.asarray(loc_p), scale=jnp.asarray(sc_p)),
                           R.Normal(loc=jnp.asarray(loc_q), scale=jnp.asarray(sc_q)), event_ndims=ndims)
        got = P.kl_normal(P.Normal(_t(loc_p), _t(sc_p)), P.Normal(_t(loc_q), _t(sc_q)), event_ndims=ndims)
        _close(got, want, f"kl_normal event_ndims={ndims}")


def _models(continuous: bool):
    """(reference models, port models loaded from them): each (world_model,
    actor, critic)."""
    from sheeprl_tpu.algos.dreamer_v1.agent import build_models as ref_build
    from sheeprl_tpu.algos.dreamer_v1.args import DreamerV1Args as RefArgs
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v1.args import DreamerV1Args
    from sheeprl_tpu_torch.interop import load_jax_params

    actions = [2] if continuous else [3]
    rspace, pspace = _spaces()
    ref = ref_build(jax.random.PRNGKey(0), actions, continuous, RefArgs(**TINY), rspace, CNN_KEYS, MLP_KEYS)
    port = build_models(torch.Generator().manual_seed(1), actions, continuous, DreamerV1Args(**TINY), pspace,
                        CNN_KEYS, MLP_KEYS)
    for r, p in zip(ref, port):
        load_jax_params(p, jax_flat(r))
    return ref, port


def test_rssm_scan_matches_the_reference():
    (rwm, *_), (pwm, *_) = _models(True)
    rng = np.random.default_rng(1)
    post0, rec0 = rng.normal(size=(B, S)).astype(np.float32), rng.normal(size=(B, R)).astype(np.float32)
    actions = rng.uniform(-1, 1, (T, B, 2)).astype(np.float32)
    embedded = rng.normal(size=(T, B, pwm.encoder.output_dim)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = rwm.rssm.scan_dynamic(*(jnp.asarray(x) for x in (post0, rec0, actions, embedded)), key)
    normals = _t(jnp.stack([jax.random.normal(jax.random.split(k)[1], (B, S)) for k in jax.random.split(key, T)]))
    got = pwm.rssm.scan_dynamic(*(_t(x) for x in (post0, rec0, actions, embedded)), normals)
    for name, g, w in zip(("recurrent", "posteriors", "post_means", "post_stds", "prior_means", "prior_stds"),
                          got, want):
        _close(g, w, name)


def _player_inputs(n: int, actions: int):
    rng = np.random.default_rng(2)
    obs = {"rgb": rng.integers(0, 255, (n, 64, 64, 3), dtype=np.uint8),
           "state": rng.normal(size=(n, 5)).astype(np.float32)}
    mid = {"actions": rng.uniform(-1, 1, (n, actions)).astype(np.float32),
           "recurrent_state": rng.normal(size=(n, R)).astype(np.float32),
           "stochastic_state": rng.normal(size=(n, S)).astype(np.float32)}
    return obs, mid


def test_player_steps_match_the_reference():
    """The greedy step (the posterior's normals given, the likeliest of 100
    tanh-normal samples) and the sampled step (`noisy_step`, exploration
    0.3), from a zero state and from one mid-episode."""
    from sheeprl_tpu.algos.dreamer_v1.agent import PlayerDV1 as RefPlayer
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerState as RefState
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerDV1
    from sheeprl_tpu_torch.algos.dreamer_v2.utils import make_device_preprocess
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState

    (rwm, ractor, _), (pwm, pactor, _) = _models(True)
    n, a, expl = 6, 2, 0.3
    common = dict(actions_dim=(a,), stochastic_size=S, recurrent_state_size=R, is_continuous=True)
    rplayer = RefPlayer(encoder=rwm.encoder, rssm=rwm.rssm, actor=ractor, **common)
    pplayer = PlayerDV1(pwm.encoder, pwm.rssm, pactor, **common)
    obs, mid = _player_inputs(n, a)
    robs = {"rgb": jnp.asarray(obs["rgb"], jnp.float32) / 255.0 - 0.5, "state": jnp.asarray(obs["state"])}
    pobs = make_device_preprocess(CNN_KEYS)({k: _t(v) for k, v in obs.items()})
    for start in ("zero", "mid"):
        rstate = rplayer.init_states(n) if start == "zero" else RefState(**{k: jnp.asarray(v) for k, v in mid.items()})
        pstate = pplayer.init_states(n) if start == "zero" else PlayerState(**{k: _t(v) for k, v in mid.items()})
        key = jax.random.PRNGKey(21)
        k_repr, k_act, k_expl = jax.random.split(key, 3)
        rnew, racts = rplayer.step(rstate, robs, key, jnp.float32(0.0), is_training=False)
        with torch.no_grad():
            pnew, pacts = pplayer.step(pstate, pobs, gumbel=_t(jax.random.normal(k_repr, (n, S))),
                                       uniforms=_t(jax.random.uniform(k_act, (100, n, a))))
        for field in ("recurrent_state", "stochastic_state"):
            _close(getattr(pnew, field), getattr(rnew, field), f"greedy {start} {field}")
        _close(pacts, racts, f"greedy {start} actions", atol=1e-4)

        rnew, racts = rplayer.step(rstate, robs, key, jnp.float32(expl), is_training=True)
        uniform = np.concatenate([np.asarray(jax.random.uniform(k, shape)) for k, shape in
                                  ((k_repr, (n, S)), (k_act, (n, a)), (k_expl, (n, a)))], -1)
        with torch.no_grad():
            pnew, pacts = pplayer.noisy_step(pstate, pobs, _t(uniform), torch.tensor(expl))
        _close(pnew.recurrent_state, rnew.recurrent_state, f"sampled {start} recurrent")
        _close(pnew.stochastic_state, rnew.stochastic_state, f"sampled {start} stochastic", atol=1e-4)
        _close(pacts, racts, f"sampled {start} actions", atol=1e-4)


def _noise(key, continuous: bool) -> dict:
    """The reference step's draws rebuilt from its key tree
    (dreamer_v1.py:124, 210, 215-218; `compute_stochastic_state` draws
    `normal(key, mean.shape)`, the RSSM's `dynamic` splits its key into the
    prior's and the posterior's): the posteriors' normals, and for each
    imagined step the actor's floats (its one head's Gumbels when
    discrete) and the prior's normals."""
    k_wm, k_img = jax.random.split(key)
    post = [jax.random.normal(jax.random.split(k)[1], (B, S)) for k in jax.random.split(k_wm, T)]
    prior, acts = [], []
    for k in jax.random.split(k_img, H):
        k_act, k_trans = jax.random.split(k)
        acts.append(jax.random.uniform(k_act, (T * B, 2)) if continuous
                    else jax.random.gumbel(jax.random.split(k_act)[1], (T * B, 3)))
        prior.append(jax.random.normal(k_trans, (T * B, S)))
    actions = _t(jnp.stack(acts))
    return {"post": _t(jnp.stack(post)), "img_prior": _t(jnp.stack(prior)),
            "img_actions": actions if continuous else [actions]}


def _batch_v1(continuous: bool) -> dict[str, np.ndarray]:
    batch = {k: v for k, v in _batch().items() if k != "is_first"}
    if continuous:
        batch["actions"] = np.random.default_rng(4).uniform(-1, 1, (T, B, 2)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=["continuous", "discrete"])
def reference_step(request):
    """(continuous, before, after, metrics, the reference state after) of the
    reference's train step."""
    from sheeprl_tpu.algos.dreamer_v1.args import DreamerV1Args as RefArgs
    from sheeprl_tpu.algos.dreamer_v1.dreamer_v1 import DV1TrainState, make_optimizers, make_train_step

    continuous = request.param == "continuous"
    (wm, actor, critic), _ = _models(continuous)
    args = RefArgs(**TINY)
    wopt, aopt, copt = make_optimizers(args)
    state = DV1TrainState(world_model=wm, actor=actor, critic=critic, world_opt=wopt.init(wm),
                          actor_opt=aopt.init(actor), critic_opt=copt.init(critic))
    before = {name: jax_flat(getattr(state, name)) for name in ("world_model", "actor", "critic")}
    step = make_train_step(args, wopt, aopt, copt, CNN_KEYS, MLP_KEYS)
    new_state, metrics = step(jax.tree_util.tree_map(jnp.copy, state),
                              {k: jnp.asarray(v) for k, v in _batch_v1(continuous).items()},
                              jax.random.PRNGKey(KEY_SEED))
    after = {name: jax_flat(getattr(new_state, name)) for name in before}
    return continuous, before, after, {k: float(v) for k, v in metrics.items()}, new_state


def _port_state(before, continuous: bool):
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v1.args import DreamerV1Args
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import DV1TrainState, make_optimizers
    from sheeprl_tpu_torch.interop import load_jax_params

    args = DreamerV1Args(**TINY)
    models = build_models(torch.Generator().manual_seed(1), [2] if continuous else [3], continuous, args,
                          _spaces()[1], CNN_KEYS, MLP_KEYS)
    for name, module in zip(("world_model", "actor", "critic"), models):
        load_jax_params(module, before[name])
    return args, DV1TrainState(*models, *make_optimizers(args, *models))


@pytest.mark.timeout(600)
def test_train_step_matches_the_reference(reference_step):
    """One teacher-forced gradient step: the 13 metrics and every parameter
    after the three Adams (behind the clip); the actor's gradient is the
    one through the imagined trajectory (dynamics backpropagation)."""
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRICS

    continuous, before, after, ref_metrics, _ = reference_step
    args, state = _port_state(before, continuous)
    metrics = make_train_step(args, CNN_KEYS, MLP_KEYS, [2] if continuous else [3], continuous)(
        state, {k: torch.from_numpy(v) for k, v in _batch_v1(continuous).items()},
        _noise(jax.random.PRNGKey(KEY_SEED), continuous))
    assert set(metrics) == set(ref_metrics) == set(METRICS)
    for name in METRICS:
        np.testing.assert_allclose(metrics[name], ref_metrics[name], rtol=1e-3, atol=1e-4, err_msg=name)
    _check_step(state, after, before, args)


def test_reference_checkpoint_carries_parameters_and_adam_moments(reference_step, tmp_path):
    """`dreamer_v1_checkpoint_from_jax` over the reference's own checkpoint:
    every parameter bit for bit, the GRUCell's two projections transposed
    in the Adam moments too, and the key contract (no target critic)."""
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as ref_save
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import checkpoint_state, restore_state
    from sheeprl_tpu_torch.interop import dreamer_v1_checkpoint_from_jax, flatten_params, state_dict_from_jax

    continuous, before, after, _, new_state = reference_step
    path = str(tmp_path / "ref_ckpt")
    ref_save(path, {"world_model": new_state.world_model, "actor": new_state.actor, "critic": new_state.critic,
                    "world_optimizer": new_state.world_opt, "actor_optimizer": new_state.actor_opt,
                    "critic_optimizer": new_state.critic_opt, "expl_decay_steps": 0, "global_step": 5,
                    "batch_size": B}, block=True)
    raw = ref_load(path)
    _, state = _port_state(before, continuous)
    converted = dreamer_v1_checkpoint_from_jax(raw, state)
    restore_state(state, converted)
    assert set(checkpoint_state(state, 0, 5, B)) == set(converted) == {
        "world_model", "actor", "critic", "world_optimizer", "actor_optimizer", "critic_optimizer",
        "expl_decay_steps", "global_step", "batch_size"}
    for name in ("world_model", "actor", "critic"):
        module = getattr(state, name)
        want = state_dict_from_jax(module, after[name])
        for path_, value in module.state_dict().items():
            assert torch.equal(value, want[path_]), f"{name}.{path_}"
    moments = flatten_params(jax.tree_util.tree_map(np.asarray, raw["world_optimizer"]))
    for proj in ("input_proj", "hidden_proj"):
        weight = getattr(state.world_model.rssm.recurrent_model.rnn, proj).weight
        ref_nu = next(v for k, v in moments.items() if k.endswith(f"nu.rssm.recurrent_model.rnn.{proj}.weight"))
        assert torch.equal(state.world_opt.state[weight]["exp_avg_sq"], torch.from_numpy(np.array(ref_nu.T)))


@pytest.mark.parametrize("continuous", [True, False])
def test_no_kernel_on_the_path(monkeypatch, continuous):
    """No kernel guard admits a V1 module: a gradient step and a sampled
    player step reach no kernel wrapper."""
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerDV1, build_models
    from sheeprl_tpu_torch.algos.dreamer_v1.args import DreamerV1Args
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import (DV1TrainState, draw_noise, make_optimizers,
                                                               make_train_step)

    calls = _spy_kernels(monkeypatch)
    args, actions = DreamerV1Args(**TINY), [2] if continuous else [3]
    wm, actor, critic = build_models(torch.Generator().manual_seed(0), actions, continuous, args, _spaces()[1],
                                     CNN_KEYS, MLP_KEYS)
    state = DV1TrainState(wm, actor, critic, *make_optimizers(args, wm, actor, critic))
    noise = draw_noise(args, T, B, actions, torch.Generator().manual_seed(0), "cpu", continuous)
    make_train_step(args, CNN_KEYS, MLP_KEYS, actions, continuous)(
        state, {k: torch.from_numpy(v) for k, v in _batch_v1(continuous).items()}, noise)
    player = PlayerDV1(wm.encoder, wm.rssm, actor, actions_dim=actions, stochastic_size=S, recurrent_state_size=R,
                       is_continuous=continuous)
    with torch.no_grad():
        player.noisy_step(player.init_states(2), {"rgb": torch.zeros(2, 64, 64, 3), "state": torch.zeros(2, 5)},
                          player.draw_noise(2, torch.Generator().manual_seed(0), "cpu"), torch.tensor(0.3))
    assert calls == []


# ---------------------------------------------------------------------------
# the entry point (the reference's tests/test_algos/test_dreamer_v1.py)
# ---------------------------------------------------------------------------

CLI_TINY = [
    "--dry_run", "--num_devices=1", "--num_envs=1", "--sync_env", "--per_rank_batch_size=1",
    "--per_rank_sequence_length=2", "--buffer_size=10", "--learning_starts=0", "--gradient_steps=1", "--horizon=8",
    "--dense_units=8", "--cnn_channels_multiplier=2", "--recurrent_state_size=8", "--hidden_size=8",
    "--stochastic_size=4", "--mlp_layers=1", "--train_every=1", "--checkpoint_every=1",
]


def _done(run_dir) -> dict:
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh][-1]


@pytest.mark.parametrize("env_id", ["discrete_dummy", "continuous_dummy"])
def test_dry_run(tmp_path, env_id):
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import main

    main(CLI_TINY + [f"--env_id={env_id}", f"--root_dir={tmp_path}", "--run_name=test", "--cnn_keys", "rgb",
                     "--device", "cpu"])
    assert any(e.startswith("ckpt_") for e in os.listdir(tmp_path / "test" / "checkpoints"))
    done = _done(tmp_path / "test")
    assert done["gradient_steps"] == 1
    assert all(done[f"Params/{m}_delta"] > 0 for m in ("world_model", "actor", "critic"))


def test_checkpoint_contract_resume_and_eval_only(tmp_path):
    """The key contract, a resume from the sidecar, a Pendulum run with the
    reference receipt's flags (`--no_use_continues`, a decaying
    exploration) resumed with its buffer, and `--eval_only`."""
    from sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1 import main
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    main(CLI_TINY + ["--env_id=discrete_dummy", f"--root_dir={tmp_path}", "--run_name=test", "--cnn_keys", "rgb",
                     "--checkpoint_buffer", "--device", "cpu"])
    ckpt = str(tmp_path / "test" / "checkpoints" / "ckpt_1")
    assert set(load_checkpoint(ckpt)) == {"world_model", "actor", "critic", "world_optimizer", "actor_optimizer",
                                          "critic_optimizer", "expl_decay_steps", "global_step", "batch_size"}
    main([f"--checkpoint_path={ckpt}"])
    assert _done(tmp_path / "test")["resumed"]["start_step"] == 2

    pendulum = ["--device", "cpu", "--env_id=Pendulum-v1", "--mlp_keys", "state", "--num_envs=1", "--sync_env",
                "--per_rank_batch_size=2", "--per_rank_sequence_length=4", "--learning_starts=8",
                "--train_every=4", "--gradient_steps=1", "--total_steps=24", "--checkpoint_every=8",
                "--dense_units=8", "--recurrent_state_size=8", "--hidden_size=8", "--stochastic_size=4",
                "--mlp_layers=1", "--horizon=3", "--buffer_size=64", "--action_repeat=1", "--no_use_continues",
                "--expl_amount=0.3", "--expl_decay", "--expl_min=0.05", "--max_step_expl_decay=4",
                "--checkpoint_buffer", f"--root_dir={tmp_path}", "--run_name=pendulum"]
    main(pendulum)
    first = _done(tmp_path / "pendulum")
    assert first["gradient_steps"] == 5 and first["player_steps"] == 16
    main([f"--checkpoint_path={tmp_path / 'pendulum' / 'checkpoints' / 'ckpt_16'}", "--total_steps=32"])
    again = _done(tmp_path / "pendulum")
    # three decays by step 16 (the gradient steps at 8, 12, 16): 0.3 - 0.25 * 3 / 4
    assert again["resumed"]["start_step"] == 17 and again["resumed"]["expl_amount"] == pytest.approx(0.1125)
    assert again["gradient_steps"] == 4

    main(["--eval_only", "--device", "cpu", f"--checkpoint_path={ckpt}", "--test_episodes=2",
          f"--root_dir={tmp_path}", "--run_name=eval"])
    done = _done(tmp_path / "eval")
    assert done["gradient_steps"] == 0 and len(done["test_returns"]) == 2


def test_every_reference_flag_parses():
    import dataclasses

    from sheeprl_tpu.algos.dreamer_v1.args import DreamerV1Args as RefArgs
    from sheeprl_tpu_torch.algos.dreamer_v1.args import DreamerV1Args

    services = {"faults", "flock", "on_nonfinite", "pipeline", "platform", "relays", "resume", "sanitize",
                "sanitize_threads"}
    ref = {f.name: f.default for f in dataclasses.fields(RefArgs)}
    port = {f.name: f.default for f in dataclasses.fields(DreamerV1Args)}
    assert set(ref) - set(port) == services
    assert {k: port[k] for k in ref if k in port} == {k: ref[k] for k in ref if k in port}


def test_training_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would be used")
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["dreamer_v1", "--env_id", "continuous_dummy"])
