"""Plan2Explore on DreamerV1 in the port against the reference, at the
reference's tiny size (`tests/test_algos/test_p2e.py:7-27`: dense 8,
recurrent 8, 3 members; a 4-wide Gaussian state, T=4, B=2, horizon 3, one
vector key, 2 continuous actions, the tanh-normal actors): the ensemble's
forward and disagreement, one exploring and one task gradient step, a
reference checkpoint carried across, the guards (no kernel on the path),
and the entry point end to end on the CPU (the reference's dry run on
pixels, and a run over the switch from exploration to the task on
Pendulum-v1, resumed past it).

Parameters come from the reference through `interop`; the Gaussian
states' draws are the reference's own normals and the actors' the floats
under its `jax.random.normal`, rebuilt from its key tree, one set for each
behaviour's imagination (`tests/test_torch_dreamer_v1.py` maps them).
Tolerances as `tests/test_torch_p2e_dv2.py`'s.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dreamer_v1 import _batch_v1
from tests.test_torch_dreamer_v2 import _close, _spaces, _spy_kernels, _t
from tests.test_torch_interop import jax_flat
from tests.test_torch_p2e_dv2 import CLI_TINY, P2E_DV1_KEYS, check_step, done_record, imagination_keys, rebuilt, \
    switch_and_resume

TINY = dict(
    dense_units=8, recurrent_state_size=8, hidden_size=8, stochastic_size=4, mlp_layers=1, num_ensembles=3,
    per_rank_batch_size=2, per_rank_sequence_length=4, horizon=3,
)
T, B, A, S, R = 4, 2, 2, 4, 8
CNN_KEYS, MLP_KEYS = [], ["state"]
KEY_SEED = 7
MODULES = ("world_model", "actor_task", "critic_task", "actor_exploration", "critic_exploration", "ensembles")


def _batch() -> dict[str, np.ndarray]:
    """DreamerV1's continuous test batch, its vector key alone."""
    return {k: v for k, v in _batch_v1(True).items() if k != "rgb"}


@rebuilt
def _noise(key) -> dict:
    """The reference step's draws rebuilt from its key tree (p2e_dv1.py:241:
    the world model's, the exploration's and the task's keys): the
    posteriors' normals, and for each behaviour's imagined steps the
    actor's floats and the prior's normals."""
    k_wm, k_expl, k_task = jax.random.split(key, 3)
    post = [jax.random.normal(jax.random.split(k)[1], (B, S)) for k in jax.random.split(k_wm, T)]
    noise = {"post": jnp.stack(post)}
    for name, k in (("exploration", k_expl), ("task", k_task)):
        noise[name] = imagination_keys(k, T * B, lambda k_act, n: jax.random.uniform(k_act, (n, A)),
                                       lambda k_trans, n: jax.random.normal(k_trans, (n, S)))
    return noise


def reference_models():
    """(reference models, the reference's flat parameters by module)."""
    from sheeprl_tpu.algos.p2e_dv1.agent import build_models as ref_build
    from sheeprl_tpu.algos.p2e_dv1.args import P2EDV1Args as RefArgs

    ref = jax.jit(lambda key: ref_build(key, [A], True, RefArgs(**TINY), _spaces()[0], CNN_KEYS, MLP_KEYS))(
        jax.random.PRNGKey(0))
    return ref, {name: jax_flat(m) for name, m in zip(MODULES, ref)}


def port_state(flat: dict):
    from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_models
    from sheeprl_tpu_torch.algos.p2e_dv1.args import P2EDV1Args
    from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1 import P2EDV1TrainState, make_optimizers
    from sheeprl_tpu_torch.interop import load_jax_params

    args = P2EDV1Args(**TINY)
    mods = build_models(torch.Generator().manual_seed(1), [A], True, args, _spaces()[1], CNN_KEYS, MLP_KEYS)
    for name, module in zip(MODULES, mods):
        load_jax_params(module, flat[name])
    return args, P2EDV1TrainState(*mods, *make_optimizers(args, *mods))


def check_ensemble(ref, flat) -> None:
    """The stacked ReLU members on an imagined trajectory's [H, T*B, in]
    input, to the embedding, and the intrinsic reward at the default
    multiplier (10,000)."""
    from sheeprl_tpu.algos.p2e_dv1.agent import ensemble_apply as ref_apply
    from sheeprl_tpu_torch.algos.p2e_dv1.agent import ensemble_apply
    from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1 import disagreement

    args, state = port_state(flat)
    x = np.random.default_rng(5).normal(size=(3, T * B, A + R + S)).astype(np.float32)
    want = jax.jit(ref_apply)(ref[-1], jnp.asarray(x))
    with torch.no_grad():
        got = ensemble_apply(state.ensembles, _t(x))
    assert got.shape == (3, 3, T * B, state.world_model.encoder.output_dim)
    _close(got, want, "members", atol=1e-6)
    mult = args.intrinsic_reward_multiplier
    _close(disagreement(state.ensembles, _t(x), mult), want.var(axis=0).mean(axis=-1, keepdims=True) * mult,
           "disagreement", atol=1e-3)


def reference_steps(ref, flat) -> dict:
    """{exploring: (state before, state after, metrics, raw state after)} of
    the reference's exploring and task steps from one state."""
    from sheeprl_tpu.algos.p2e_dv1 import p2e_dv1 as ref_mod
    from sheeprl_tpu.algos.p2e_dv1.args import P2EDV1Args as RefArgs

    args = RefArgs(**TINY)
    opts = ref_mod.make_optimizers(args)

    def initial(named):
        return ref_mod.P2EDV1TrainState(**named, world_opt=opts[0].init(named["world_model"]),
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
        step = ref_mod.make_train_step(args, opts, CNN_KEYS, MLP_KEYS, exploring=exploring)
        new_state, metrics = step(copy(state), data, jax.random.PRNGKey(KEY_SEED))
        out[exploring] = (flat, {name: jax_flat(getattr(new_state, name)) for name in MODULES},
                          {k: float(v) for k, v in metrics.items()}, new_state)
    return out


def check_train_steps(steps: dict) -> None:
    """One teacher-forced gradient step of each program: every metric and
    every parameter after the six Adams (behind the clips and the 1e-6
    weight decay; the actors' gradients through the imagined trajectories);
    the task program leaves the ensemble and the exploration behaviour
    untouched."""
    from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1 import METRICS_EXPLORING, METRICS_TASK, make_train_step

    for exploring, (before, after, ref_metrics, _) in steps.items():
        args, state = port_state(before)
        metrics = make_train_step(args, CNN_KEYS, MLP_KEYS, [A], True, exploring=exploring)(
            state, {k: torch.from_numpy(v) for k, v in _batch().items()},
            _noise(jax.random.PRNGKey(KEY_SEED), exploring))
        assert set(metrics) == set(ref_metrics) == set(METRICS_EXPLORING if exploring else METRICS_TASK)
        for name in metrics:
            np.testing.assert_allclose(metrics[name], ref_metrics[name], rtol=1e-3, atol=1e-4, err_msg=name)
        trained = {"world_model", "actor_task", "critic_task"}
        if exploring:
            trained |= {"actor_exploration", "critic_exploration", "ensembles"}
        check_step(state, before, after, args, trained)


def check_reference_checkpoint(steps: dict, path: str) -> None:
    """The reference's checkpoint after its exploring step -> the port's
    state: every parameter and the ensemble's Adam moments bit for bit,
    and the key contract (no target critics)."""
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu.utils.checkpoint import save_checkpoint as ref_save
    from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import checkpoint_state, restore_state
    from sheeprl_tpu_torch.interop import flatten_params, p2e_checkpoint_from_jax, state_dict_from_jax

    before, after, _, new = steps[True]
    ref_save(path, {**{name: getattr(new, name) for name in MODULES}, "world_optimizer": new.world_opt,
                    "actor_task_optimizer": new.actor_task_opt, "critic_task_optimizer": new.critic_task_opt,
                    "ensemble_optimizer": new.ensemble_opt,
                    "actor_exploration_optimizer": new.actor_exploration_opt,
                    "critic_exploration_optimizer": new.critic_exploration_opt, "expl_decay_steps": 0,
                    "global_step": 5, "batch_size": B}, block=True)
    raw = ref_load(path)
    _, state = port_state(before)
    converted = p2e_checkpoint_from_jax(raw, state)
    restore_state(state, converted)
    assert set(checkpoint_state(state, 0, 5, B)) == set(converted) == P2E_DV1_KEYS
    for name in MODULES:
        module = getattr(state, name)
        want = state_dict_from_jax(module, after[name])
        for path_, value in module.state_dict().items():
            assert torch.equal(value, want[path_]), f"{name}.{path_}"
    moments = flatten_params(jax.tree_util.tree_map(np.asarray, raw["ensemble_optimizer"]))
    head = state.ensembles.head.weight
    ref_nu = next(v for k, v in moments.items() if k.endswith("nu.head.weight"))
    assert torch.equal(state.ensemble_opt.state[head]["exp_avg_sq"], torch.from_numpy(np.array(ref_nu)))


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


@pytest.mark.parametrize("continuous", [True, False])
def test_no_kernel_on_the_path(monkeypatch, continuous):
    """No kernel guard admits a P2E-DV1 module: both programs' steps and both
    behaviours' player steps reach no kernel wrapper."""
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import PlayerDV1
    from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_models
    from sheeprl_tpu_torch.algos.p2e_dv1.args import P2EDV1Args
    from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1 import P2EDV1TrainState, draw_noise, make_optimizers, make_train_step

    calls = _spy_kernels(monkeypatch)
    args, actions = P2EDV1Args(**TINY), [A] if continuous else [3]
    mods = build_models(torch.Generator().manual_seed(0), actions, continuous, args, _spaces()[1], CNN_KEYS,
                        MLP_KEYS)
    state = P2EDV1TrainState(*mods, *make_optimizers(args, *mods))
    batch = _batch_v1(continuous)
    batch.pop("rgb")
    for exploring in (True, False):
        noise = draw_noise(args, T, B, actions, torch.Generator().manual_seed(0), "cpu", continuous, exploring)
        make_train_step(args, CNN_KEYS, MLP_KEYS, actions, continuous, exploring=exploring)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()}, noise)
    for actor in (state.actor_exploration, state.actor_task):
        player = PlayerDV1(state.world_model.encoder, state.world_model.rssm, actor, actions_dim=actions,
                           stochastic_size=S, recurrent_state_size=R, is_continuous=continuous)
        with torch.no_grad():
            player.noisy_step(player.init_states(2), {"state": torch.zeros(2, 5)},
                              player.draw_noise(2, torch.Generator().manual_seed(0), "cpu"), torch.tensor(0.3))
    assert calls == []


# ---------------------------------------------------------------------------
# the entry point (the reference's tests/test_algos/test_p2e.py)
# ---------------------------------------------------------------------------


def test_dry_run(tmp_path):
    """The reference's dry run, its flags verbatim, on the CPU (discrete
    actions; the switch run below takes continuous ones)."""
    from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1 import main

    main(CLI_TINY + ["--stochastic_size=4", "--env_id=discrete_dummy", f"--root_dir={tmp_path}", "--run_name=test",
                     "--cnn_keys", "rgb", "--device", "cpu"])
    done = done_record(tmp_path / "test")
    assert done["gradient_steps"] == 1 and done["graph_calls"]["train_step_task"] == 1
    assert done["Params/world_model_delta"] > 0 and done["Params/actor_task_delta"] > 0


def test_checkpoint_contract_and_resume_across_the_switch(tmp_path):
    from sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1 import main

    switch_and_resume(main, tmp_path, ["--env_id=Pendulum-v1", "--mlp_keys", "state", "--stochastic_size=4"],
                      P2E_DV1_KEYS)


def test_every_reference_flag_parses():
    import dataclasses

    from sheeprl_tpu.algos.p2e_dv1.args import P2EDV1Args as RefArgs
    from sheeprl_tpu_torch.algos.p2e_dv1.args import P2EDV1Args

    services = {"faults", "flock", "on_nonfinite", "pipeline", "platform", "relays", "resume", "sanitize",
                "sanitize_threads"}
    ref = {f.name: f.default for f in dataclasses.fields(RefArgs)}
    port = {f.name: f.default for f in dataclasses.fields(P2EDV1Args)}
    assert set(ref) - set(port) == services
    assert {k: port[k] for k in ref if k in port} == {k: ref[k] for k in ref if k in port}


def test_training_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would be used")
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["p2e_dv1", "--env_id", "continuous_dummy"])
