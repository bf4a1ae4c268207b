"""Plan2Explore on DreamerV2 in the port against the reference, at the
reference's tiny size (`tests/test_algos/test_p2e.py:7-27`: dense 8,
recurrent 8, 3 members; 4 x 4 latents, T=4, B=2, horizon 3, one vector
key, 3 discrete actions): the ensemble's forward and disagreement, one
exploring and one task gradient step, a reference checkpoint carried
across, the guards (no kernel on the path), the exploring step under bf16
and `--remat`, and the entry point end to end on the CPU (the reference's
dry runs on pixels, and a run over the switch from exploration to the task
on CartPole-v1, resumed past it).

Parameters come from the reference through `interop` (the stacked
ensemble's `[n, in, out]` weights as they are); every categorical draw is
`argmax(logits + gumbel)` with the Gumbels rebuilt from the reference's key
tree, one set for each behaviour's imagination. Tolerances: the ensemble
f32 at rtol 1e-5 (atol 1e-6); the gradient steps as in
`tests/test_torch_dreamer_v2.py` (the metrics rtol 1e-3, atol 1e-4; the
parameters after Adam atol 2 lr + 1e-6; the target critics, copied at tau
1, atol 1e-6); what a program does not update, bit for bit.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dreamer_v2 import _batch as _dv2_batch
from tests.test_torch_dreamer_v2 import _close, _spaces, _spy_kernels, _t
from tests.test_torch_interop import jax_flat

TINY = dict(
    cnn_channels_multiplier=2, dense_units=8, recurrent_state_size=8, hidden_size=8, stochastic_size=4,
    discrete_size=4, mlp_layers=1, num_ensembles=3, per_rank_batch_size=2, per_rank_sequence_length=4, horizon=3,
)
T, B, A, S, D, H = 4, 2, 3, 4, 4, 3
CNN_KEYS, MLP_KEYS = [], ["state"]
KEY_SEED = 7
MODULES = ("world_model", "actor_task", "critic_task", "target_critic_task", "actor_exploration",
           "critic_exploration", "target_critic_exploration", "ensembles")
P2E_DV1_KEYS = {
    "world_model", "actor_task", "critic_task", "ensembles", "world_optimizer", "actor_task_optimizer",
    "critic_task_optimizer", "ensemble_optimizer", "expl_decay_steps", "global_step", "batch_size",
    "actor_exploration", "critic_exploration", "actor_exploration_optimizer", "critic_exploration_optimizer",
}


def _batch() -> dict[str, np.ndarray]:
    """DreamerV2's test batch, its vector key alone."""
    return {k: v for k, v in _dv2_batch().items() if k != "rgb"}


def lrs(args) -> dict[str, float]:
    """The learning rate of each trained module."""
    return {"world_model": args.world_lr, "actor_task": args.actor_lr, "critic_task": args.critic_lr,
            "actor_exploration": args.actor_lr, "critic_exploration": args.critic_lr, "ensembles": args.ensemble_lr}


def imagination_keys(key, n: int, draw_action, draw_prior) -> dict:
    """One behaviour's imagination draws rebuilt from its key (the
    reference's `behaviour_update`: H step keys, each split into the
    actor's and the transition's)."""
    prior, acts = [], []
    for k in jax.random.split(key, H):
        k_act, k_trans = jax.random.split(k)
        acts.append(draw_action(k_act, n))
        prior.append(draw_prior(k_trans, n))
    return {"img_prior": jnp.stack(prior), "img_actions": jnp.stack(acts)}


def rebuilt(draws):
    """`draws(key)` of every part of the step's noise traced and compiled as
    one program (not one for each random op's shape); `(key, exploring)`
    -> the parts that program takes, as torch tensors."""
    program = jax.jit(draws)

    def noise(key, exploring: bool) -> dict:
        parts = program(key)
        if not exploring:
            del parts["exploration"]
        return jax.tree_util.tree_map(_t, parts)

    return noise


@rebuilt
def _noise(key) -> dict:
    """The reference step's Gumbels rebuilt from its key tree
    (p2e_dv2.py:281: the world model's, the exploration's and the task's
    keys; the V2 RSSM's `dynamic` splits each step key into the prior's
    and the posterior's)."""
    k_wm, k_expl, k_task = jax.random.split(key, 3)
    post = [jax.random.gumbel(jax.random.split(k)[1], (B, S, D)) for k in jax.random.split(k_wm, T)]
    noise = {"post": jnp.stack(post)}
    for name, k in (("exploration", k_expl), ("task", k_task)):
        draws = imagination_keys(k, T * B, lambda k_act, n: jax.random.gumbel(jax.random.split(k_act)[1], (n, A)),
                                 lambda k_trans, n: jax.random.gumbel(k_trans, (n, S, D)))
        noise[name] = {"img_prior": draws["img_prior"], "img_actions": [draws["img_actions"]]}
    return noise


def reference_models():
    """(reference models, the reference's flat parameters by module)."""
    from sheeprl_tpu.algos.p2e_dv2.agent import build_models as ref_build
    from sheeprl_tpu.algos.p2e_dv2.args import P2EDV2Args as RefArgs

    # one jitted build: a compile of the whole init, not one an op
    ref = jax.jit(lambda key: ref_build(key, [A], False, RefArgs(**TINY), _spaces()[0], CNN_KEYS, MLP_KEYS))(
        jax.random.PRNGKey(0))
    return ref, {name: jax_flat(m) for name, m in zip(MODULES, ref)}


def port_state(flat: dict | None = None, **overrides):
    """The port's P2E-DV2 state, with the reference's parameters when given."""
    from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_models
    from sheeprl_tpu_torch.algos.p2e_dv2.args import P2EDV2Args
    from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2 import P2EDV2TrainState, make_optimizers
    from sheeprl_tpu_torch.interop import load_jax_params

    args = P2EDV2Args(**TINY, **overrides)
    mods = build_models(torch.Generator().manual_seed(1), [A], False, args, _spaces()[1], CNN_KEYS, MLP_KEYS)
    for name, module in zip(MODULES, mods):
        if flat is not None:
            load_jax_params(module, flat[name])
    return args, P2EDV2TrainState(*mods, *make_optimizers(args, *mods))


def check_ensemble(ref, flat) -> None:
    """The stacked members on an imagined trajectory's [H+1, T*B, in]
    input, and the intrinsic reward (their variance, averaged, times the
    multiplier)."""
    from sheeprl_tpu.algos.p2e_dv2.agent import ensemble_apply as ref_apply
    from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1 import disagreement
    from sheeprl_tpu_torch.algos.p2e_dv2.agent import ensemble_apply

    _, state = port_state(flat)
    x = np.random.default_rng(5).normal(size=(H + 1, T * B, A + 8 + S * D)).astype(np.float32)
    want = jax.jit(ref_apply)(ref[-1], jnp.asarray(x))
    with torch.no_grad():
        got = ensemble_apply(state.ensembles, _t(x))
    assert got.shape == (3, H + 1, T * B, S * D)
    _close(got, want, "members", atol=1e-6)
    _close(disagreement(state.ensembles, _t(x), 2.5), want.var(axis=0).mean(axis=-1, keepdims=True) * 2.5,
           "disagreement", atol=1e-6)


def reference_steps(ref, flat) -> dict:
    """{exploring: (state before, state after, metrics, raw state after)} of
    the reference's exploring and task steps at tau 1, from one state."""
    from sheeprl_tpu.algos.p2e_dv2 import p2e_dv2 as ref_mod
    from sheeprl_tpu.algos.p2e_dv2.args import P2EDV2Args as RefArgs

    args = RefArgs(**TINY)
    opts = ref_mod.make_optimizers(args)

    def initial(named):
        return ref_mod.P2EDV2TrainState(**named, world_opt=opts[0].init(named["world_model"]),
                                        actor_task_opt=opts[1].init(named["actor_task"]),
                                        critic_task_opt=opts[2].init(named["critic_task"]),
                                        actor_exploration_opt=opts[3].init(named["actor_exploration"]),
                                        critic_exploration_opt=opts[4].init(named["critic_exploration"]),
                                        ensemble_opt=opts[5].init(named["ensembles"]))

    # the initial state and its copies each one compiled program, not one for each leaf's shape
    state = jax.jit(initial)(dict(zip(MODULES, ref)))
    copy = jax.jit(lambda tree: jax.tree_util.tree_map(jnp.copy, tree))
    data = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = {}
    for exploring in (True, False):
        step = ref_mod.make_train_step(args, opts, CNN_KEYS, MLP_KEYS, [A], False, exploring=exploring)
        new_state, metrics = step(copy(state), data, jax.random.PRNGKey(KEY_SEED), jnp.float32(1.0))
        out[exploring] = (flat, {name: jax_flat(getattr(new_state, name)) for name in MODULES},
                          {k: float(v) for k, v in metrics.items()}, new_state)
    return out


def check_step(state, before: dict, after: dict, args, trained: set[str]) -> None:
    """Every module after the step against the reference's: a trained one
    within 2 lr + 1e-6 and moved, a target critic within 1e-6, the rest
    bit for bit unchanged."""
    from sheeprl_tpu_torch.interop import state_dict_from_jax

    rates = lrs(args)
    for name in before:
        module = getattr(state, name)
        got, want = module.state_dict(), state_dict_from_jax(module, after[name])
        start = state_dict_from_jax(module, before[name])
        if name not in trained and not name.startswith("target_"):
            assert all(torch.equal(got[p], start[p]) for p in got), f"{name} moved"
            continue
        atol = 2 * rates[name] + 1e-6 if name in rates else 1e-6
        for path in got:
            _close(got[path], want[path], f"{name}.{path}", rtol=0, atol=atol)
        if name in rates:
            assert max(float((got[p] - start[p]).abs().max()) for p in got) > 0.5 * rates[name], name


def check_train_steps(steps: dict) -> None:
    """One teacher-forced gradient step of each program: every metric, every
    parameter after the six Adams (behind the clips and the 1e-6 weight
    decay), both hard target copies at tau 1; the task program leaves the
    ensemble and the exploration behaviour untouched."""
    from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2 import METRICS_EXPLORING, METRICS_TASK, make_train_step

    for exploring, (before, after, ref_metrics, _) in steps.items():
        args, state = port_state(before)
        metrics = make_train_step(args, CNN_KEYS, MLP_KEYS, [A], False, exploring=exploring)(
            state, {k: torch.from_numpy(v) for k, v in _batch().items()}, 1.0,
            _noise(jax.random.PRNGKey(KEY_SEED), exploring))
        assert set(metrics) == set(ref_metrics) == set(METRICS_EXPLORING if exploring else METRICS_TASK)
        for name in metrics:
            np.testing.assert_allclose(metrics[name], ref_metrics[name], rtol=1e-3, atol=1e-4, err_msg=name)
        trained = set(lrs(args)) if exploring else {"world_model", "actor_task", "critic_task"}
        check_step(state, before, after, args, trained)


def check_reference_checkpoint(steps: dict, path: str) -> None:
    """The reference's checkpoint after its exploring step (its own save and
    raw load) -> `p2e_checkpoint_from_jax` -> the port's state: every
    parameter and Adam moment bit for bit, the ensemble's stacked moments
    unchanged in layout, the counters and the key contract."""
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as ref_save
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import checkpoint_state, restore_state
    from sheeprl_tpu_torch.interop import flatten_params, p2e_checkpoint_from_jax, state_dict_from_jax

    before, after, _, new = steps[True]
    opts = {"world_optimizer": new.world_opt, "actor_task_optimizer": new.actor_task_opt,
            "critic_task_optimizer": new.critic_task_opt, "ensemble_optimizer": new.ensemble_opt,
            "actor_exploration_optimizer": new.actor_exploration_opt,
            "critic_exploration_optimizer": new.critic_exploration_opt}
    ref_save(path, {**{name: getattr(new, name) for name in MODULES}, **opts, "expl_decay_steps": 2,
                    "global_step": 9, "batch_size": B}, block=True)
    raw = ref_load(path)
    _, state = port_state(before)
    converted = p2e_checkpoint_from_jax(raw, state)
    restore_state(state, converted)
    assert set(checkpoint_state(state, 2, 9, B)) == set(converted) == P2E_DV1_KEYS | {
        "target_critic_task", "target_critic_exploration"}
    for name in MODULES:
        module = getattr(state, name)
        want = state_dict_from_jax(module, after[name])
        for path_, value in module.state_dict().items():
            assert torch.equal(value, want[path_]), f"{name}.{path_}"
    moments = flatten_params(jax.tree_util.tree_map(np.asarray, raw["ensemble_optimizer"]))
    weight = state.ensembles.layers[0].weight
    got = state.ensemble_opt.state[weight]
    assert float(got["step"]) == 1.0
    ref_mu = next(v for k, v in moments.items() if k.endswith("mu.layers.0.weight"))
    assert torch.equal(got["exp_avg"], torch.from_numpy(np.array(ref_mu)))  # [n, in, out] both sides
    assert (converted["expl_decay_steps"], converted["global_step"], converted["batch_size"]) == (2, 9, B)


@pytest.mark.timeout(600)
def test_ensemble_steps_and_checkpoint_match_the_reference(tmp_path):
    """Against the reference, from its parameters (one test, so that its
    two compiled programs are built once): the ensemble's forward and
    disagreement, one exploring and one task gradient step, and its
    checkpoint carried into the port."""
    ref, flat = reference_models()
    check_ensemble(ref, flat)
    steps = reference_steps(ref, flat)
    check_train_steps(steps)
    check_reference_checkpoint(steps, str(tmp_path / "ref_ckpt"))


def _port_step(exploring: bool = True, **overrides):
    """(metrics, state) of the port's step from its own seeded parameters and
    the reference's draws (with `overrides` of the config)."""
    from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2 import make_train_step

    args, state = port_state(**overrides)
    metrics = make_train_step(args, CNN_KEYS, MLP_KEYS, [A], False, exploring=exploring)(
        state, {k: torch.from_numpy(v) for k, v in _batch().items()}, 1.0,
        _noise(jax.random.PRNGKey(KEY_SEED), exploring))
    return metrics, state


@pytest.mark.parametrize("precision,remat", [("bfloat16", "off"), ("float32", "on")])
def test_exploring_step_under_bf16_and_remat(precision, remat):
    """The exploring step (ensemble fit, intrinsic reward, both behaviours)
    under `--precision bfloat16` and under `--remat on`, which checkpoints
    both imaginations (the reference's test_precision.py:234-300): every
    metric finite, an intrinsic reward above 0 (computed in f32: bf16
    rounding noise would floor it); under remat the metrics and parameters
    of the f32 step bit for bit."""
    metrics, state = _port_step(precision=precision, remat=remat)
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    assert metrics["Rewards/intrinsic"] > 0 and metrics["Loss/ensemble_loss"] > 0
    if remat == "on":
        want, plain = _port_step()
        assert metrics == want
        for name in MODULES:
            a, b = getattr(state, name).state_dict(), getattr(plain, name).state_dict()
            assert all(torch.equal(a[k], b[k]) for k in a), name


def test_no_kernel_on_the_path(monkeypatch):
    """No kernel guard admits a P2E module (DreamerV2's, also with
    `--layer_norm`, and the plain stacked members): both programs' steps
    and both behaviours' player steps reach no kernel wrapper."""
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import PlayerDV2
    from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_models
    from sheeprl_tpu_torch.algos.p2e_dv2.args import P2EDV2Args
    from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2 import P2EDV2TrainState, draw_noise, make_optimizers, make_train_step

    calls = _spy_kernels(monkeypatch)
    args = P2EDV2Args(**TINY, layer_norm=True)
    mods = build_models(torch.Generator().manual_seed(0), [A], False, args, _spaces()[1], CNN_KEYS, MLP_KEYS)
    state = P2EDV2TrainState(*mods, *make_optimizers(args, *mods))
    for exploring in (True, False):
        noise = draw_noise(args, T, B, [A], torch.Generator().manual_seed(0), "cpu", exploring=exploring)
        make_train_step(args, CNN_KEYS, MLP_KEYS, [A], False, exploring=exploring)(
            state, {k: torch.from_numpy(v) for k, v in _batch().items()}, 1.0, noise)
    for actor in (state.actor_exploration, state.actor_task):
        player = PlayerDV2(state.world_model.encoder, state.world_model.rssm, actor, actions_dim=(A,),
                           stochastic_size=S, discrete_size=D, recurrent_state_size=8)
        with torch.no_grad():
            player.noisy_step(player.init_states(2), {"state": torch.zeros(2, 5)},
                              player.draw_noise(2, torch.Generator().manual_seed(0), "cpu"), torch.tensor(0.1))
    assert calls == []


# ---------------------------------------------------------------------------
# the entry point (the reference's tests/test_algos/test_p2e.py)
# ---------------------------------------------------------------------------

# the reference's TINY_COMMON (tests/test_algos/test_p2e.py:9-27), verbatim
CLI_TINY = [
    "--dry_run", "--num_devices=1", "--num_envs=1", "--sync_env", "--per_rank_batch_size=1",
    "--per_rank_sequence_length=2", "--buffer_size=10", "--learning_starts=0", "--gradient_steps=1", "--horizon=8",
    "--dense_units=8", "--cnn_channels_multiplier=2", "--recurrent_state_size=8", "--hidden_size=8",
    "--num_ensembles=3", "--mlp_layers=1", "--train_every=1", "--checkpoint_every=1",
]
# a run whose switch falls in its middle: 6 steps of exploration (the
# gradient steps from step 4), then the task, a checkpoint at step 8
SWITCH_RUN = [
    "--num_envs=1", "--sync_env", "--per_rank_batch_size=2", "--per_rank_sequence_length=3", "--buffer_size=64",
    "--learning_starts=4", "--gradient_steps=1", "--train_every=1", "--action_repeat=1",
    "--exploration_steps=6", "--total_steps=12", "--checkpoint_every=8", "--checkpoint_buffer", "--horizon=3",
    "--dense_units=8", "--recurrent_state_size=8", "--hidden_size=8", "--num_ensembles=3", "--mlp_layers=1",
    "--device", "cpu",
]


def done_record(run_dir) -> dict:
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh][-1]


def switch_and_resume(main, tmp_path, extra: list[str], keys: set[str]) -> None:
    """A run over the switch (both programs, each its graph entries, one
    zero-shot episode at step 6), the reference's key contract, and a
    resume from step 8 that keeps the task program."""
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    main(SWITCH_RUN + extra + [f"--root_dir={tmp_path}", "--run_name=switch"])
    done = done_record(tmp_path / "switch")
    assert done["exploration_updates"] == 6 and done["zero_shot"]["step"] == 6
    # gradient steps at 4 and 5 exploring, 6-12 on the task; the player from step 5
    assert done["graph_calls"] == {"train_step_exploring": 2, "player_step_exploring": 1, "train_step_task": 7,
                                   "player_step_task": 7}
    assert done["Params/ensembles_delta"] > 0 and done["Params/actor_task_delta"] > 0
    ckpt = tmp_path / "switch" / "checkpoints" / "ckpt_8"
    assert set(load_checkpoint(str(ckpt))) == keys
    main([f"--checkpoint_path={ckpt}"])
    again = done_record(tmp_path / "switch")
    assert again["resumed"]["start_step"] == 9 and again["resumed"]["exploring"] is False
    assert again["graph_calls"] == {"train_step_task": 4, "player_step_task": 4} and again["zero_shot"] is None
    assert set(again["compile_stats"]["entries"]) == {"train_step_task", "player_step_task"}
    assert again["Params/ensembles_delta"] == 0.0 and again["Params/actor_exploration_delta"] == 0.0


@pytest.mark.parametrize("env_id", ["discrete_dummy", "continuous_dummy"])
def test_dry_run(tmp_path, env_id):
    """The reference's dry run, its flags verbatim, on the CPU: the switch
    falls on its one step, so it trains the task program once."""
    from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2 import main

    main(CLI_TINY + ["--stochastic_size=4", "--discrete_size=4", f"--env_id={env_id}", f"--root_dir={tmp_path}",
                     "--run_name=test", "--cnn_keys", "rgb", "--device", "cpu"])
    done = done_record(tmp_path / "test")
    assert done["gradient_steps"] == 1 and done["graph_calls"]["train_step_task"] == 1
    assert done["Params/world_model_delta"] > 0 and done["Params/actor_task_delta"] > 0


def test_checkpoint_contract_and_resume_across_the_switch(tmp_path):
    from sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2 import main

    switch_and_resume(main, tmp_path, ["--env_id=CartPole-v1", "--mlp_keys", "state", "--stochastic_size=4",
                                       "--discrete_size=4", "--pretrain_steps=1"],
                      P2E_DV1_KEYS | {"target_critic_task", "target_critic_exploration"})


def test_every_reference_flag_parses():
    """The port's parser takes every flag of the reference's P2EDV2Args but
    the reference's runtime services (ROADMAP Queue A items 8-10), at the
    reference's defaults."""
    import dataclasses

    from sheeprl_tpu.algos.p2e_dv2.args import P2EDV2Args as RefArgs
    from sheeprl_tpu_torch.algos.p2e_dv2.args import P2EDV2Args

    services = {"faults", "flock", "on_nonfinite", "pipeline", "platform", "relays", "resume", "sanitize",
                "sanitize_threads"}
    ref = {f.name: f.default for f in dataclasses.fields(RefArgs)}
    port = {f.name: f.default for f in dataclasses.fields(P2EDV2Args)}
    assert set(ref) - set(port) == services
    assert {k: port[k] for k in ref if k in port} == {k: ref[k] for k in ref if k in port}


def test_training_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would be used")
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["p2e_dv2", "--env_id", "discrete_dummy"])
