"""DreamerV2 in the port against the reference, at a tiny size (cnn
multiplier 2, dense 16, 4 x 4 latents, T=4, B=2, horizon 3, 64x64 rgb plus
one vector key, 3 discrete actions): the RSSM's scan, the player's step, one
whole gradient step, a reference checkpoint carried across, the guards
(no kernel on the path), and the entry point end to end on the CPU.

Parameters come from the reference through `interop`; every categorical
draw is `argmax(logits + gumbel)` with the Gumbels rebuilt from the
reference's key tree. Tolerances: the scan and the player step f32 at rtol
1e-5 (atol 1e-5 near zero); the gradient step as in
`tests/test_torch_dv3_train.py` (the metrics rtol 1e-3, atol 1e-4; the
parameters after Adam atol 2 lr + 1e-6, since Adam's first step is about lr
sign(g) and a gradient near zero may round to either sign; the target
critic, copied at tau 1, atol 1e-6).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_anakin import _tiny_uniform
from tests.test_torch_interop import jax_flat

TINY = dict(
    cnn_channels_multiplier=2, dense_units=16, recurrent_state_size=16, hidden_size=16,
    stochastic_size=4, discrete_size=4, mlp_layers=2, per_rank_batch_size=2,
    per_rank_sequence_length=4, horizon=3,
)
T, B, A, S, D, H, R = 4, 2, 3, 4, 4, 3, 16
VECTOR = 5
CNN_KEYS, MLP_KEYS = ["rgb"], ["state"]
KEY_SEED = 7
RTOL = ATOL = 1e-5


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, what: str, rtol: float = RTOL, atol: float = ATOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _spaces():
    import gymnasium as gym

    from sheeprl_tpu_torch.envs import spaces

    ref = {"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8),
           "state": gym.spaces.Box(-np.inf, np.inf, (VECTOR,), np.float32)}
    port = {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-np.inf, np.inf, (VECTOR,))}
    return ref, port


@pytest.fixture(scope="module")
def models():
    """(reference models, port models, loaded from the reference's): each
    (world_model, actor, critic, target_critic)."""
    from sheeprl_tpu.algos.dreamer_v2.agent import build_models as ref_build
    from sheeprl_tpu.algos.dreamer_v2.args import DreamerV2Args as RefArgs
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v2.args import DreamerV2Args
    from sheeprl_tpu_torch.interop import load_jax_params

    rspace, pspace = _spaces()
    ref = ref_build(jax.random.PRNGKey(0), [A], False, RefArgs(**TINY), rspace, CNN_KEYS, MLP_KEYS)
    port = build_models(torch.Generator().manual_seed(1), [A], False, DreamerV2Args(**TINY), pspace, CNN_KEYS,
                        MLP_KEYS)
    for r, p in zip(ref, port):
        load_jax_params(p, jax_flat(r))
    return ref, port


def _batch() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    dones, is_first = np.zeros((T, B, 1), np.float32), np.zeros((T, B, 1), np.float32)
    dones[1, 0] = 1.0  # an episode ends inside the window and the next one starts
    is_first[2, 0] = 1.0
    return {
        "rgb": rng.integers(0, 255, (T, B, 64, 64, 3), dtype=np.uint8),
        "state": rng.normal(size=(T, B, VECTOR)).astype(np.float32),
        "actions": np.eye(A, dtype=np.float32)[rng.integers(0, A, (T, B))],
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def _noise(key) -> dict:
    """The reference step's Gumbel draws rebuilt from its key tree
    (dreamer_v2.py:137, 239, 245-250; the V2 RSSM's `dynamic` splits its
    step key into the prior's and the posterior's): the posteriors', and
    for each of the H imagined steps the actor head's and the prior's."""
    k_wm, k_img = jax.random.split(key)
    post = [jax.random.gumbel(jax.random.split(k)[1], (B, S, D)) for k in jax.random.split(k_wm, T)]
    prior, acts = [], []
    for k in jax.random.split(k_img, H):
        k_act, k_trans = jax.random.split(k)
        acts.append(jax.random.gumbel(jax.random.split(k_act)[1], (T * B, A)))
        prior.append(jax.random.gumbel(k_trans, (T * B, S, D)))
    return {"post": _t(jnp.stack(post)), "img_prior": _t(jnp.stack(prior)), "img_actions": [_t(jnp.stack(acts))]}


def test_rssm_scan_matches_the_reference(models):
    """The V2 `is_first` (zeroing, no re-seed), the biased LayerNorm-GRU and
    the unmixed heads over a sequence with an episode start inside it."""
    (rwm, *_), (pwm, *_) = models
    rng = np.random.default_rng(1)
    post0 = np.eye(D, dtype=np.float32)[rng.integers(0, D, (B, S))]
    rec0 = rng.normal(size=(B, R)).astype(np.float32)
    actions = np.eye(A, dtype=np.float32)[rng.integers(0, A, (T, B))]
    embedded = rng.normal(size=(T, B, pwm.encoder.output_dim)).astype(np.float32)
    is_first = np.zeros((T, B, 1), np.float32)
    is_first[2, 1] = 1.0
    key = jax.random.PRNGKey(3)
    want = rwm.rssm.scan_dynamic(*(jnp.asarray(x) for x in (post0, rec0, actions, embedded, is_first)), key)
    gumbels = _t(jnp.stack([jax.random.gumbel(jax.random.split(k)[1], (B, S, D))
                            for k in jax.random.split(key, T)]))
    got = pwm.rssm.scan_dynamic(*(_t(x) for x in (post0, rec0, actions, embedded, is_first)), gumbels)
    for name, g, w in zip(("recurrent", "priors_logits", "posteriors", "posteriors_logits"), got, want):
        _close(g, w, name)


def test_player_step_matches_the_reference(models):
    """`PlayerDV2.noisy_step` from the reference's step key: the posterior's
    and the actor's Gumbels and each head's exploration draws, from a
    zero-initialized state (V2's) and from one mid-episode."""
    from sheeprl_tpu.algos.dreamer_v2.agent import PlayerDV2 as RefPlayer
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerState as RefState
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2
    from sheeprl_tpu_torch.algos.dreamer_v2.utils import make_device_preprocess
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState

    (rwm, ractor, *_), (pwm, pactor, *_) = models
    n, expl = 6, 0.4
    common = dict(actions_dim=(A,), stochastic_size=S, discrete_size=D, recurrent_state_size=R, is_continuous=False)
    rplayer = RefPlayer(encoder=rwm.encoder, rssm=rwm.rssm, actor=ractor, **common)
    pplayer = PlayerDV2(pwm.encoder, pwm.rssm, pactor, **common)
    zero = pplayer.init_states(n)
    for field in ("actions", "recurrent_state", "stochastic_state"):
        _close(getattr(zero, field), getattr(rplayer.init_states(n), field), f"init {field}", rtol=0, atol=0)
    rng = np.random.default_rng(2)
    obs = {"rgb": rng.integers(0, 255, (n, 64, 64, 3), dtype=np.uint8),
           "state": rng.normal(size=(n, VECTOR)).astype(np.float32)}
    mid = {"actions": np.eye(A, dtype=np.float32)[rng.integers(0, A, n)],
           "recurrent_state": rng.normal(size=(n, R)).astype(np.float32),
           "stochastic_state": np.eye(D, dtype=np.float32)[rng.integers(0, D, (n, S))].reshape(n, -1)}
    rprep = jnp.asarray(obs["rgb"], jnp.float32) / 255.0 - 0.5
    for start in ("zero", "mid"):
        key = jax.random.PRNGKey(11 if start == "zero" else 12)
        rstate = rplayer.init_states(n) if start == "zero" else RefState(**{k: jnp.asarray(v) for k, v in mid.items()})
        pstate = zero if start == "zero" else PlayerState(**{k: _t(v) for k, v in mid.items()})
        rnew, racts = rplayer.step(rstate, {"rgb": rprep, "state": jnp.asarray(obs["state"])}, key,
                                   jnp.float32(expl), is_training=True)
        k_repr, k_act, k_expl = jax.random.split(key, 3)
        k_expl, k_u, k_s = jax.random.split(k_expl, 3)
        idx = np.asarray(jax.random.randint(k_u, (n,), 0, A))
        uniform = np.concatenate([
            _tiny_uniform(k_repr, (n, S, D)).reshape(n, S * D), _tiny_uniform(jax.random.split(k_act)[1], (n, A)),
            ((idx + 0.5) / A).astype(np.float32)[:, None], np.asarray(jax.random.uniform(k_s, (n,)))[:, None],
        ], -1)
        dev_obs = make_device_preprocess(CNN_KEYS)({k: _t(v) for k, v in obs.items()})
        with torch.no_grad():
            pnew, pacts = pplayer.noisy_step(pstate, dev_obs, _t(uniform), torch.tensor(expl))
        _close(pacts, racts, f"{start} actions")
        for field in ("actions", "recurrent_state", "stochastic_state"):
            _close(getattr(pnew, field), getattr(rnew, field), f"{start} {field}")


@pytest.fixture(scope="module")
def reference_step(models):
    """(state before, state after, metrics) of the reference's train step at
    tau 1, each state as flat numpy per module; and the raw reference state
    after, for the checkpoint test."""
    from sheeprl_tpu.algos.dreamer_v2.args import DreamerV2Args as RefArgs
    from sheeprl_tpu.algos.dreamer_v2.dreamer_v2 import DV2TrainState, make_optimizers, make_train_step

    (wm, actor, critic, target), _ = models
    args = RefArgs(**TINY)
    wopt, aopt, copt = make_optimizers(args)
    state = DV2TrainState(world_model=wm, actor=actor, critic=critic, target_critic=target,
                          world_opt=wopt.init(wm), actor_opt=aopt.init(actor), critic_opt=copt.init(critic))
    before = {name: jax_flat(getattr(state, name)) for name in ("world_model", "actor", "critic", "target_critic")}
    step = make_train_step(args, wopt, aopt, copt, CNN_KEYS, MLP_KEYS, [A], False)
    new_state, metrics = step(jax.tree_util.tree_map(jnp.copy, state), {k: jnp.asarray(v) for k, v in _batch().items()},
                              jax.random.PRNGKey(KEY_SEED), jnp.float32(1.0))
    after = {name: jax_flat(getattr(new_state, name)) for name in before}
    return before, after, {k: float(v) for k, v in metrics.items()}, new_state


def _port_state(before):
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v2.args import DreamerV2Args
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2TrainState, make_optimizers
    from sheeprl_tpu_torch.interop import load_jax_params

    args = DreamerV2Args(**TINY)
    models = build_models(torch.Generator().manual_seed(1), [A], False, args, _spaces()[1], CNN_KEYS, MLP_KEYS)
    for name, module in zip(("world_model", "actor", "critic", "target_critic"), models):
        load_jax_params(module, before[name])
    return args, DV2TrainState(*models, *make_optimizers(args, *models[:3]))


def _check_step(state, after, before, args) -> None:
    from sheeprl_tpu_torch.interop import state_dict_from_jax

    lrs = {"world_model": args.world_lr, "actor": args.actor_lr, "critic": args.critic_lr}
    for name in ("world_model", "actor", "critic", "target_critic"):
        if not hasattr(state, name):  # DreamerV1 has no target critic
            continue
        module = getattr(state, name)
        atol = 2 * lrs[name] + 1e-6 if name in lrs else 1e-6
        got, want = module.state_dict(), state_dict_from_jax(module, after[name])
        for path in got:
            _close(got[path], want[path], f"{name}.{path}", rtol=0, atol=atol)
        if name in lrs:  # the step moved the module
            start = state_dict_from_jax(module, before[name])
            assert max(float((got[p] - start[p]).abs().max()) for p in got) > 0.5 * lrs[name], name


@pytest.mark.timeout(600)
def test_train_step_matches_the_reference(reference_step):
    """One teacher-forced gradient step: the 13 metrics, every parameter
    after the three Adams (behind the clip and the 1e-6 weight decay), and
    the hard target copy at tau 1."""
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRICS

    before, after, ref_metrics, _ = reference_step
    args, state = _port_state(before)
    metrics = make_train_step(args, CNN_KEYS, MLP_KEYS, [A], False)(
        state, {k: torch.from_numpy(v) for k, v in _batch().items()}, 1.0, _noise(jax.random.PRNGKey(KEY_SEED)))
    assert set(metrics) == set(ref_metrics) == set(METRICS)
    for name in METRICS:
        np.testing.assert_allclose(metrics[name], ref_metrics[name], rtol=1e-3, atol=1e-4, err_msg=name)
    _check_step(state, after, before, args)


def test_reference_checkpoint_carries_parameters_and_adam_moments(reference_step, tmp_path):
    """The reference's checkpoint (its own save and raw load) after the step
    -> `dreamer_v2_checkpoint_from_jax` -> the port's state: every parameter
    and Adam moment bit for bit, the step counts, and the key contract."""
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as ref_save
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import checkpoint_state, restore_state
    from sheeprl_tpu_torch.interop import dreamer_v2_checkpoint_from_jax, flatten_params, state_dict_from_jax

    before, after, _, new_state = reference_step
    path = str(tmp_path / "ref_ckpt")
    ref_save(path, {"world_model": new_state.world_model, "actor": new_state.actor, "critic": new_state.critic,
                    "target_critic": new_state.target_critic, "world_optimizer": new_state.world_opt,
                    "actor_optimizer": new_state.actor_opt, "critic_optimizer": new_state.critic_opt,
                    "expl_decay_steps": 3, "global_step": 9, "batch_size": B}, block=True)
    raw = ref_load(path)
    _, state = _port_state(before)
    converted = dreamer_v2_checkpoint_from_jax(raw, state)
    restore_state(state, converted)
    assert set(checkpoint_state(state, 3, 9, B)) == set(converted) == {
        "world_model", "actor", "critic", "target_critic", "world_optimizer", "actor_optimizer",
        "critic_optimizer", "expl_decay_steps", "global_step", "batch_size"}
    for name in ("world_model", "actor", "critic", "target_critic"):
        module = getattr(state, name)
        want = state_dict_from_jax(module, after[name])
        for path_, value in module.state_dict().items():
            assert torch.equal(value, want[path_]), f"{name}.{path_}"
    wm = state.world_model
    mu = flatten_params(jax.tree_util.tree_map(np.asarray, raw["world_optimizer"]))
    gru = "rssm.recurrent_model.rnn.proj.weight"
    got = state.world_opt.state[wm.rssm.recurrent_model.rnn.proj.weight]
    assert float(got["step"]) == 1.0
    ref_mu = next(v for k, v in mu.items() if k.endswith(f"mu.{gru}"))
    assert torch.equal(got["exp_avg"], torch.from_numpy(np.array(ref_mu.T)))  # [in, out] -> [out, in]
    assert (converted["expl_decay_steps"], converted["global_step"], converted["batch_size"]) == (3, 9, B)


def _spy_kernels(monkeypatch) -> list[str]:
    """Replace every kernel wrapper at its call site by a spy that records
    its name and calls through."""
    import sheeprl_tpu_torch.algos.dreamer_v3.agent as dv3_agent
    import sheeprl_tpu_torch.nn.blocks as blocks
    import sheeprl_tpu_torch.nn.layers as layers
    import sheeprl_tpu_torch.nn.recurrent as recurrent
    import sheeprl_tpu_torch.ops.distributions as distributions
    import sheeprl_tpu_torch.ops.math as math_ops

    calls: list[str] = []
    for module, name in ((recurrent, "layernorm_gru_cell"), (blocks, "conv_ln_silu"), (blocks, "deconv_ln_silu"),
                         (layers, "subpixel_deconv"), (dv3_agent, "fused_rssm_step"),
                         (distributions, "two_hot_log_prob"), (math_ops, "two_hot")):
        real = getattr(module, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("layer_norm", [False, True])
def test_no_kernel_on_the_path(reference_step, monkeypatch, layer_norm):
    """The reference's guards refuse every V2 module (VALID ELU convs with
    biases, the biased GRU, the fused RSSM step's biased layers), also with
    `--layer_norm`, so the port's do: a gradient step and a player step
    reach no kernel wrapper."""
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2, build_models
    from sheeprl_tpu_torch.algos.dreamer_v2.args import DreamerV2Args
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import DV2TrainState, make_optimizers, make_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import draw_noise

    calls = _spy_kernels(monkeypatch)
    args = DreamerV2Args(**TINY, layer_norm=layer_norm)
    models = build_models(torch.Generator().manual_seed(0), [A], False, args, _spaces()[1], CNN_KEYS, MLP_KEYS)
    state = DV2TrainState(*models, *make_optimizers(args, *models[:3]))
    noise = draw_noise(args, T, B, [A], torch.Generator().manual_seed(0), "cpu")
    make_train_step(args, CNN_KEYS, MLP_KEYS, [A], False)(
        state, {k: torch.from_numpy(v) for k, v in _batch().items()}, 1.0, noise)
    player = PlayerDV2(models[0].encoder, models[0].rssm, models[1], actions_dim=(A,), stochastic_size=S,
                       discrete_size=D, recurrent_state_size=R)
    with torch.no_grad():
        player.noisy_step(player.init_states(2), {"rgb": torch.zeros(2, 64, 64, 3), "state": torch.zeros(2, VECTOR)},
                          player.draw_noise(2, torch.Generator().manual_seed(0), "cpu"), torch.tensor(0.1))
    assert calls == []
    assert models[0].rssm._fused_step_weights(torch.float32) is None


# ---------------------------------------------------------------------------
# the entry point (the reference's tests/test_algos/test_dreamer_v2.py)
# ---------------------------------------------------------------------------

CLI_TINY = [
    "--dry_run", "--num_devices=1", "--num_envs=1", "--sync_env", "--per_rank_batch_size=1",
    "--per_rank_sequence_length=2", "--buffer_size=10", "--learning_starts=0", "--pretrain_steps=1",
    "--gradient_steps=1", "--horizon=4", "--dense_units=8", "--cnn_channels_multiplier=2",
    "--recurrent_state_size=8", "--hidden_size=8", "--stochastic_size=4", "--discrete_size=4", "--mlp_layers=1",
    "--train_every=1", "--checkpoint_every=1",
]


def _done(run_dir) -> dict:
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh][-1]


@pytest.mark.parametrize("env_id", ["discrete_dummy", "continuous_dummy"])
@pytest.mark.parametrize("buffer_type", ["sequential", "episode"])
def test_dry_run(tmp_path, env_id, buffer_type):
    """The reference's dry run, its flags verbatim, on the CPU."""
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import main

    main(CLI_TINY + [f"--env_id={env_id}", f"--buffer_type={buffer_type}", f"--root_dir={tmp_path}",
                     "--run_name=test", "--cnn_keys", "rgb", "--device", "cpu"])
    ckpt_dir = tmp_path / "test" / "checkpoints"
    assert any(e.startswith("ckpt_") for e in os.listdir(ckpt_dir))
    done = _done(tmp_path / "test")
    assert done["gradient_steps"] == 1 and done["buffer_type"] == buffer_type
    assert all(done[f"Params/{m}_delta"] > 0 for m in ("world_model", "actor", "critic"))


def test_checkpoint_contract_resume_and_eval_only(tmp_path):
    """The reference's key contract and buffer sidecar, a resume from the
    checkpoint (config from the sidecar), a longer run resumed with its
    buffer, and `--eval_only`, which trains nothing."""
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import main
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    main(CLI_TINY + ["--env_id=discrete_dummy", f"--root_dir={tmp_path}", "--run_name=test", "--cnn_keys", "rgb",
                     "--checkpoint_buffer", "--device", "cpu"])
    ckpt = str(tmp_path / "test" / "checkpoints" / "ckpt_1")
    raw = load_checkpoint(ckpt)
    assert set(raw) == {"world_model", "actor", "critic", "target_critic", "world_optimizer", "actor_optimizer",
                        "critic_optimizer", "expl_decay_steps", "global_step", "batch_size"}
    assert os.path.exists(ckpt + "_buffer.npz")
    main([f"--checkpoint_path={ckpt}"])
    assert _done(tmp_path / "test")["resumed"]["start_step"] == 2

    # a run that trains past its checkpoint, resumed with its buffer: the
    # episode buffer on Pendulum-v1 (its 200-step episodes; training waits
    # for the first), prioritizing the episodes' ends
    long = ["--device", "cpu", "--env_id=Pendulum-v1", "--mlp_keys", "state", "--num_envs=1",
            "--per_rank_batch_size=2", "--per_rank_sequence_length=3", "--learning_starts=8", "--pretrain_steps=2",
            "--train_every=4", "--total_steps=216", "--checkpoint_every=208", "--dense_units=8",
            "--recurrent_state_size=8", "--hidden_size=8", "--stochastic_size=4", "--discrete_size=4",
            "--mlp_layers=1", "--horizon=3", "--buffer_size=512", "--action_repeat=1", "--buffer_type=episode",
            "--prioritize_ends", "--checkpoint_buffer", f"--root_dir={tmp_path}", "--run_name=long"]
    main(long)
    first = _done(tmp_path / "long")
    # the first episode lands at step 200; then a gradient step every 4
    assert first["gradient_steps"] == 5 and first["player_steps"] == 208
    main([f"--checkpoint_path={tmp_path / 'long' / 'checkpoints' / 'ckpt_208'}", "--total_steps=232"])
    again = _done(tmp_path / "long")
    assert again["resumed"]["start_step"] == 209 and again["resumed"]["buffer"].endswith("ckpt_208_buffer.npz")
    assert again["gradient_steps"] == 6

    main(["--eval_only", "--device", "cpu", f"--checkpoint_path={ckpt}", "--test_episodes=2",
          f"--root_dir={tmp_path}", "--run_name=eval"])
    done = _done(tmp_path / "eval")
    assert done["gradient_steps"] == 0 and len(done["test_returns"]) == 2


def test_every_reference_flag_parses():
    """The port's parser takes every flag of the reference's DreamerV2Args
    but the reference's runtime services (ROADMAP Queue A items 8-10), at
    the reference's defaults."""
    import dataclasses

    from sheeprl_tpu.algos.dreamer_v2.args import DreamerV2Args as RefArgs
    from sheeprl_tpu_torch.algos.dreamer_v2.args import DreamerV2Args

    services = {"faults", "flock", "on_nonfinite", "pipeline", "platform", "relays", "resume", "sanitize",
                "sanitize_threads"}
    ref = {f.name: f.default for f in dataclasses.fields(RefArgs)}
    port = {f.name: f.default for f in dataclasses.fields(DreamerV2Args)}
    assert set(ref) - set(port) == services
    assert {k: port[k] for k in ref if k in port} == {k: ref[k] for k in ref if k in port}


def test_training_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would be used")
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["dreamer_v2", "--env_id", "discrete_dummy"])
