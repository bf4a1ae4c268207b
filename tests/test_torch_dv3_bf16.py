"""One whole DreamerV3 gradient step of the port on vector observations
against the reference's `make_train_step`, with `--precision bfloat16` and
with float32, at a tiny size (dense, recurrent and hidden 16, 4x4 discrete
latents, T=4, B=2, horizon 3, one 4-wide `state` key, 2 discrete actions),
and the CartPole bf16 slice end to end through the port's CLI on the CPU.

At these widths both sides' RSSM takes the fused step: the reference runs
`set_pallas(True, interpret=True)` with the GRU, two-hot and CNN kernel
families switched off (`SHEEPRL_TPU_PALLAS_{GRU,TWO_HOT,CNN}=0`), so its
only Pallas kernel is `fused_rssm_step`, in interpret mode; the port's
`RSSM` takes `fused_rssm_step`, whose CPU path is the plain version. The
reference's Gumbel draws are rebuilt from its key tree and injected into
the port's step, as in tests/test_torch_dv3_train.py.

Tolerances. float32: the 13 metrics at rtol 1e-3, atol 1e-4 (f32 sums in
other orders, as in test_torch_dv3_train.py). bfloat16: the metrics at rtol
3e-2, atol 3e-3. A bf16 value carries 8 significant bits, so every
rounding of an activation is worth up to 2^-9 (2e-3) of it, and the two
frameworks round at different points: PyTorch's CPU bf16 products sum in
f32 and round once at the output, XLA's may round partial sums, and the
elementwise chains (LayerNorm's affine, SiLU, the residual adds) round
after each op in one and not the other. Through the encoder's 2 layers,
4 recurrent steps, the decoder's 2 layers and the heads, about ten such
roundings stack on the path to each loss: ten times 2^-9 is 2e-2, taken
with 1.5x headroom as 3e-2 (the largest deviation measured on the CPU is
5.3e-3, the critic's gradient norm). The atol covers metrics that are
near zero (the policy loss, the actor's gradient norm).
Parameters after the step, in both dtypes: atol 2*lr + 1e-6 per module
(Adam's first step moves each parameter by at most lr; a gradient near
zero whose sign the two sides' rounding flips moves it by lr either way);
the EMA target critic (tau 1) equals the pre-update critic to 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_interop import jax_flat

TINY = dict(
    dense_units=16, recurrent_state_size=16, hidden_size=16, stochastic_size=4, discrete_size=4,
    mlp_layers=2, per_rank_batch_size=2, per_rank_sequence_length=4, horizon=3,
)
T, B, A, S, D, H = 4, 2, 2, 4, 4, 3
VECTOR = 4
MLP_KEYS = ["state"]
KEY_SEED = 9
TOL = {"float32": (1e-3, 1e-4), "bfloat16": (3e-2, 3e-3)}  # metrics (rtol, atol)


def _batch() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(1)
    dones = np.zeros((T, B, 1), np.float32)
    is_first = np.zeros((T, B, 1), np.float32)
    dones[1, 1] = 1.0  # an episode ends inside the window and the next one starts
    is_first[2, 1] = 1.0
    return {
        "state": rng.normal(size=(T, B, VECTOR)).astype(np.float32),
        "actions": np.eye(A, dtype=np.float32)[rng.integers(0, A, (T, B))],
        "rewards": np.ones((T, B, 1), np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def _noise(key) -> dict:
    """The reference step's Gumbel draws, rebuilt from its key tree (the
    same tree as in test_torch_dv3_train.py: the fused branch of `dynamic`
    draws the posterior with the same key as the unfused one)."""
    k_wm, k_img = jax.random.split(key)
    post = [jax.random.gumbel(jax.random.split(k)[1], (B, S, D)) for k in jax.random.split(k_wm, T)]
    img_keys = jax.random.split(k_img, H + 1)

    def actor_draw(k):
        _, sub = jax.random.split(k)
        return jax.random.gumbel(sub, (T * B, A))

    prior, acts = [], []
    for h in range(H):
        k_act, k_trans = jax.random.split(img_keys[h])
        acts.append(actor_draw(k_act))
        prior.append(jax.random.gumbel(k_trans, (T * B, S, D)))
    acts.append(actor_draw(img_keys[H]))
    t = lambda xs: torch.from_numpy(np.array(jnp.stack(xs)))  # noqa: E731
    return {"post": t(post), "img_prior": t(prior), "img_actions": [t(acts)]}


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def reference_step(request):
    """(precision, jax state before, jax state after, jax metrics, jax
    moments, whether the reference took its fused step): the reference's
    train step with only its RSSM kernel on, in interpret mode."""
    import gymnasium as gym

    from sheeprl_tpu import ops
    from sheeprl_tpu.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import DV3TrainState, make_optimizers, make_train_step
    from sheeprl_tpu.ops import pallas_kernels as pk

    precision = request.param
    args = DreamerV3Args(**TINY, precision=precision)
    space = {"state": gym.spaces.Box(-np.inf, np.inf, (VECTOR,), np.float32)}
    wm, actor, critic, target = build_models(jax.random.PRNGKey(0), [A], False, args, space, [], MLP_KEYS)
    wopt, aopt, copt = make_optimizers(args)
    state = DV3TrainState(
        world_model=wm, actor=actor, critic=critic, target_critic=target,
        world_opt=wopt.init(wm), actor_opt=aopt.init(actor), critic_opt=copt.init(critic),
        moments=ops.Moments.init(args.moments_decay, args.moment_max, args.moments_percentile_low,
                                 args.moments_percentile_high),
    )
    before = {name: jax_flat(getattr(state, name)) for name in ("world_model", "actor", "critic", "target_critic")}
    data = {k: jnp.asarray(v) for k, v in _batch().items()}
    with pytest.MonkeyPatch.context() as mp:
        for kind in ("GRU", "TWO_HOT", "CNN"):
            mp.setenv(f"SHEEPRL_TPU_PALLAS_{kind}", "0")
        pk.set_pallas(True, interpret=True)
        try:
            dt = ops.precision.compute_dtype(precision)
            x = jnp.zeros((B, S * D + A), dt)
            fused = wm.rssm._fused_step_weights(x, jnp.zeros((B, 16), dt)) is not None
            step = make_train_step(args, wopt, aopt, copt, [], MLP_KEYS, [A], False)
            new_state, metrics = step(jax.tree_util.tree_map(jnp.copy, state), data,
                                      jax.random.PRNGKey(KEY_SEED), jnp.float32(1.0))
            metrics = {k: float(v) for k, v in metrics.items()}
        finally:
            pk.set_pallas(None, interpret=False)
    after = {name: jax_flat(getattr(new_state, name)) for name in before}
    moments = (float(new_state.moments.low), float(new_state.moments.high))
    return precision, before, after, metrics, moments, fused


def _port_state(before, precision):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3TrainState, make_optimizers
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop import load_jax_params
    from sheeprl_tpu_torch.ops.moments import Moments

    args = DreamerV3Args(**TINY, precision=precision)
    space = {"state": spaces.Box(-np.inf, np.inf, (VECTOR,))}
    wm, actor, critic, target = build_models(torch.Generator().manual_seed(1), [A], False, args, space, [], MLP_KEYS)
    for name, module in zip(("world_model", "actor", "critic", "target_critic"), (wm, actor, critic, target)):
        load_jax_params(module, before[name])
    state = DV3TrainState(
        wm, actor, critic, target, *make_optimizers(args, wm, actor, critic),
        Moments(args.moments_decay, args.moment_max, args.moments_percentile_low, args.moments_percentile_high),
    )
    return args, state


@pytest.mark.timeout(900)
def test_train_step_matches_reference(reference_step, monkeypatch):
    import sheeprl_tpu_torch.algos.dreamer_v3.agent as agent_mod
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRICS, make_train_step
    from sheeprl_tpu_torch.interop import state_dict_from_jax

    precision, before, after, ref_metrics, ref_moments, ref_fused = reference_step
    assert ref_fused, "the reference's RSSM must take its fused step at these widths"
    args, state = _port_state(before, precision)
    calls = []
    fused = agent_mod.fused_rssm_step

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return fused(*a, **kw)

    monkeypatch.setattr(agent_mod, "fused_rssm_step", counted)
    step = make_train_step(args, [], MLP_KEYS, [A], False)
    data = {k: torch.from_numpy(v) for k, v in _batch().items()}
    metrics = step(state, data, 1.0, _noise(jax.random.PRNGKey(KEY_SEED)))
    want_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    assert calls == [want_dtype] * T  # the port's RSSM took the fused step at every scan step

    rtol, atol = TOL[precision]
    assert set(metrics) == set(ref_metrics) == set(METRICS)
    for name in METRICS:
        assert np.isfinite(metrics[name]), name
        np.testing.assert_allclose(metrics[name], ref_metrics[name], rtol=rtol, atol=atol, err_msg=name)
    np.testing.assert_allclose([float(state.moments.low), float(state.moments.high)], ref_moments,
                               rtol=rtol, atol=atol)
    lrs = {"world_model": args.world_lr, "actor": args.actor_lr, "critic": args.critic_lr}
    for name, module in (("world_model", state.world_model), ("actor", state.actor),
                         ("critic", state.critic), ("target_critic", state.target_critic)):
        atol_p = 2 * lrs[name] + 1e-6 if name in lrs else 1e-6
        got = module.state_dict()
        assert all(p.dtype == torch.float32 for p in got.values()), name  # f32 master parameters
        want, start = state_dict_from_jax(module, after[name]), state_dict_from_jax(module, before[name])
        for path in got:
            np.testing.assert_allclose(got[path].numpy(), want[path].numpy(), rtol=0, atol=atol_p,
                                       err_msg=f"{name}.{path}")
        if name in lrs:  # the step moved the module
            moved = max(float((got[p] - start[p]).abs().max()) for p in got)
            assert moved > 0.5 * lrs[name], name


@pytest.mark.timeout(300)
def test_cartpole_bf16_cli_run_takes_the_fused_step(tmp_path, monkeypatch):
    """`python -m sheeprl_tpu_torch dreamer_v3 --env_id CartPole-v1
    --mlp_keys state --precision bfloat16 --device cpu` at a tiny size,
    in this process: every scan step of every gradient step goes through
    `fused_rssm_step` in bf16, every loss is finite and every model moves."""
    import json

    import sheeprl_tpu_torch.algos.dreamer_v3.agent as agent_mod
    from sheeprl_tpu_torch.cli import run

    calls = []
    fused = agent_mod.fused_rssm_step

    def counted(*a, **kw):
        calls.append(a[0].dtype)
        return fused(*a, **kw)

    monkeypatch.setattr(agent_mod, "fused_rssm_step", counted)
    run([
        "dreamer_v3", "--device", "cpu", "--env_id", "CartPole-v1", "--mlp_keys", "state",
        "--precision", "bfloat16", "--num_envs", "1", "--root_dir", str(tmp_path), "--run_name", "run",
        "--dense_units", "16", "--hidden_size", "16", "--recurrent_state_size", "16",
        "--stochastic_size", "4", "--discrete_size", "4", "--mlp_layers", "2",
        "--per_rank_batch_size", "2", "--per_rank_sequence_length", "4", "--horizon", "3",
        "--buffer_size", "64", "--learning_starts", "16", "--train_every", "1", "--pretrain_steps", "2",
        "--total_steps", "24", "--bins", "15",
    ])
    with open(tmp_path / "run" / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    steps, done = records[:-1], records[-1]
    assert done["event"] == "done" and done["gradient_steps"] == 10 and done["player_steps"] == 8
    assert done["env_steps"] == 24
    assert calls == [torch.bfloat16] * (4 * done["gradient_steps"])  # T = 4 scan steps each
    assert all(np.isfinite(r[k]) for r in steps for k in r if k.startswith(("Loss/", "Grads/")))
    assert all(done[f"Params/{m}_delta"] > 0 for m in ("world_model", "actor", "critic"))
