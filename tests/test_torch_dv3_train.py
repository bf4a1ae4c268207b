"""One whole DreamerV3 gradient step of the port against the reference's
`make_train_step`, at a tiny size (cnn multiplier 2, dense 16, T=4, B=2,
horizon 3, 64x64 rgb plus one vector key, 3 discrete actions), and the
port's training entry point end to end on the CPU.

The reference's step runs on its default CPU path (Pallas off); its
parameters are carried into the port by `interop`. Every categorical draw
of the reference's step is `argmax(logits + jax.random.gumbel(key, shape))`
(`jax.random.categorical`); the test rebuilds those Gumbel draws from the
reference's key tree and feeds them to the port's step.

Tolerances. The 13 metrics: rtol 1e-3, atol 1e-4 (both sides sum f32 over
64x64x3 pixels and 255 bins in different orders; the losses are O(1e3)).
Parameters after the step: atol 2*lr + 1e-6 per module. Adam's first step
is lr * g / (|g| + eps), about lr * sign(g): where a gradient is near zero
the two sides' rounding can flip its sign, which moves that parameter by
up to 2*lr. The EMA target critic (tau 1 at the first step) must equal the
pre-update critic: atol 1e-6.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_interop import jax_flat

TINY = dict(
    cnn_channels_multiplier=2, dense_units=16, recurrent_state_size=16, hidden_size=16,
    stochastic_size=4, discrete_size=4, mlp_layers=2, per_rank_batch_size=2,
    per_rank_sequence_length=4, horizon=3,
)
T, B, A, S, D, H = 4, 2, 3, 4, 4, 3
VECTOR = 5
CNN_KEYS, MLP_KEYS = ["rgb"], ["state"]
KEY_SEED = 7


def _batch() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    dones = np.zeros((T, B, 1), np.float32)
    is_first = np.zeros((T, B, 1), np.float32)
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
    """The reference step's Gumbel draws, rebuilt from its key tree
    (dreamer_v3.py:172, 292, 298-302; agent.py:457, 516, 679-680)."""
    k_wm, k_img = jax.random.split(key)
    post = [jax.random.gumbel(jax.random.split(k)[1], (B, S, D)) for k in jax.random.split(k_wm, T)]
    img_keys = jax.random.split(k_img, H + 1)

    def actor_draw(k):
        _, sub = jax.random.split(k)  # one head: key, sub = split(key)
        return jax.random.gumbel(sub, (T * B, A))

    prior, acts = [], []
    for h in range(H):
        k_act, k_trans = jax.random.split(img_keys[h])
        acts.append(actor_draw(k_act))
        prior.append(jax.random.gumbel(k_trans, (T * B, S, D)))
    acts.append(actor_draw(img_keys[H]))
    t = lambda xs: torch.from_numpy(np.array(jnp.stack(xs)))  # noqa: E731
    return {"post": t(post), "img_prior": t(prior), "img_actions": [t(acts)]}


@pytest.fixture(scope="module")
def reference_step():
    """(jax state before, jax state after, jax metrics, jax moments): the
    reference's train step, compiled and run once per module."""
    import gymnasium as gym

    from sheeprl_tpu import ops
    from sheeprl_tpu.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import DV3TrainState, make_optimizers, make_train_step

    args = DreamerV3Args(**TINY)
    space = {
        "rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8),
        "state": gym.spaces.Box(-np.inf, np.inf, (VECTOR,), np.float32),
    }
    wm, actor, critic, target = build_models(jax.random.PRNGKey(0), [A], False, args, space, CNN_KEYS, MLP_KEYS)
    wopt, aopt, copt = make_optimizers(args)
    state = DV3TrainState(
        world_model=wm, actor=actor, critic=critic, target_critic=target,
        world_opt=wopt.init(wm), actor_opt=aopt.init(actor), critic_opt=copt.init(critic),
        moments=ops.Moments.init(args.moments_decay, args.moment_max, args.moments_percentile_low,
                                 args.moments_percentile_high),
    )
    before = {name: jax_flat(getattr(state, name)) for name in ("world_model", "actor", "critic", "target_critic")}
    step = make_train_step(args, wopt, aopt, copt, CNN_KEYS, MLP_KEYS, [A], False)
    data = {k: jnp.asarray(v) for k, v in _batch().items()}
    new_state, metrics = step(jax.tree_util.tree_map(jnp.copy, state), data, jax.random.PRNGKey(KEY_SEED),
                              jnp.float32(1.0))
    after = {name: jax_flat(getattr(new_state, name)) for name in before}
    moments = (float(new_state.moments.low), float(new_state.moments.high))
    return before, after, {k: float(v) for k, v in metrics.items()}, moments


def _port_state(before):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3TrainState, make_optimizers
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop import load_jax_params
    from sheeprl_tpu_torch.ops.moments import Moments

    args = DreamerV3Args(**TINY)
    space = {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8), "state": spaces.Box(-np.inf, np.inf, (VECTOR,))}
    wm, actor, critic, target = build_models(
        torch.Generator().manual_seed(1), [A], False, args, space, CNN_KEYS, MLP_KEYS
    )
    for name, module in zip(("world_model", "actor", "critic", "target_critic"), (wm, actor, critic, target)):
        load_jax_params(module, before[name])
    state = DV3TrainState(
        wm, actor, critic, target, *make_optimizers(args, wm, actor, critic),
        Moments(args.moments_decay, args.moment_max, args.moments_percentile_low, args.moments_percentile_high),
    )
    return args, state


@pytest.mark.timeout(600)
def test_injected_noise_is_the_references_own_draw():
    """The rebuilt posterior noise of step 0 reproduces the reference's
    `jax.random.categorical` draw on the same logits."""
    from sheeprl_tpu.ops.distributions import OneHotCategorical

    key = jax.random.PRNGKey(KEY_SEED)
    k_wm, _ = jax.random.split(key)
    k_post = jax.random.split(jax.random.split(k_wm, T)[0])[1]
    logits = jnp.asarray(np.random.default_rng(3).normal(size=(B, S, D)).astype(np.float32))
    sample = OneHotCategorical.from_logits(logits).sample(k_post)
    mine = jnp.argmax(jnp.asarray(_noise(key)["post"][0].numpy()) + logits, axis=-1)
    np.testing.assert_array_equal(np.asarray(mine), np.asarray(jnp.argmax(sample, axis=-1)))


@pytest.mark.timeout(600)
def test_train_step_matches_reference(reference_step):
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRICS, make_train_step
    from sheeprl_tpu_torch.interop import state_dict_from_jax

    before, after, ref_metrics, ref_moments = reference_step
    args, state = _port_state(before)
    step = make_train_step(args, CNN_KEYS, MLP_KEYS, [A], False)
    data = {k: torch.from_numpy(v) for k, v in _batch().items()}
    metrics = step(state, data, 1.0, _noise(jax.random.PRNGKey(KEY_SEED)))

    assert set(metrics) == set(ref_metrics) == set(METRICS)
    for name in METRICS:
        np.testing.assert_allclose(metrics[name], ref_metrics[name], rtol=1e-3, atol=1e-4, err_msg=name)
    np.testing.assert_allclose([float(state.moments.low), float(state.moments.high)], ref_moments,
                               rtol=1e-3, atol=1e-5)
    lrs = {"world_model": args.world_lr, "actor": args.actor_lr, "critic": args.critic_lr}
    for name, module in (("world_model", state.world_model), ("actor", state.actor),
                         ("critic", state.critic), ("target_critic", state.target_critic)):
        atol = 2 * lrs[name] + 1e-6 if name in lrs else 1e-6
        got = module.state_dict()
        want, start = state_dict_from_jax(module, after[name]), state_dict_from_jax(module, before[name])
        for path in got:
            np.testing.assert_allclose(got[path].numpy(), want[path].numpy(), rtol=0, atol=atol,
                                       err_msg=f"{name}.{path}")
        if name in lrs:  # the step moved the module
            moved = max(float((got[p] - start[p]).abs().max()) for p in got)
            assert moved > 0.5 * lrs[name], name


@pytest.mark.timeout(300)
def test_cpu_training_run_end_to_end(tmp_path):
    """`python -m sheeprl_tpu_torch dreamer_v3 --device cpu` at a tiny size:
    random collection up to learning_starts, then player steps and gradient
    steps; every loss finite, every model moved."""
    argv = [
        sys.executable, "-m", "sheeprl_tpu_torch", "dreamer_v3", "--device", "cpu",
        "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "2",
        "--root_dir", str(tmp_path), "--run_name", "run", "--cnn_channels_multiplier", "2",
        "--dense_units", "16", "--hidden_size", "16", "--recurrent_state_size", "16",
        "--stochastic_size", "4", "--discrete_size", "4", "--per_rank_batch_size", "2",
        "--per_rank_sequence_length", "4", "--horizon", "3", "--learning_starts", "16",
        "--total_steps", "24", "--train_every", "2", "--pretrain_steps", "2", "--buffer_size", "64",
        "--bins", "15",
    ]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(tmp_path / "run" / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    steps, done = records[:-1], records[-1]
    assert done["event"] == "done" and done["gradient_steps"] == 6 and done["player_steps"] == 4
    assert done["env_steps"] == 24 and len(done["train_step_ms"]) == 6
    assert all(np.isfinite(r[k]) for r in steps for k in r if k.startswith(("Loss/", "Grads/")))
    assert all(done[f"Params/{m}_delta"] > 0 for m in ("world_model", "actor", "critic"))


def test_training_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device would be used")
    from sheeprl_tpu_torch.cli import run

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["dreamer_v3", "--env_id", "discrete_dummy"])


@pytest.mark.parametrize("obs,dtype,fits,millions", [
    ("pixels", jnp.float32, False, 5.77), ("pixels", jnp.bfloat16, False, 5.77),
    ("vector", jnp.float32, False, 3.93), ("vector", jnp.bfloat16, True, 3.93),
])
def test_fused_rssm_guard_at_default_width(obs, dtype, fits, millions):
    """The reference's fused RSSM step (`fused_rssm_step`) is off on the
    training path: at DreamerV3's default width its step weights exceed the
    reference's 10 MiB guard on 64x64 pixels in either dtype; on vector
    observations (MLP encoder, E = 512) in bf16 they fit."""
    from sheeprl_tpu.ops.pallas_kernels import fused_rssm_supported
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.envs import spaces

    if obs == "pixels":
        space, cnn_keys, mlp_keys = {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}, ["rgb"], []
    else:
        space, cnn_keys, mlp_keys = {"state": spaces.Box(-np.inf, np.inf, (17,))}, [], ["state"]
    wm, _, _, _ = build_models(torch.Generator().manual_seed(0), [2], False, DreamerV3Args(), space, cnn_keys,
                               mlp_keys)
    rm, tm, pm = wm.rssm.recurrent_model, wm.rssm.transition_model, wm.rssm.representation_model
    mats = [rm.mlp.layers[0].weight, rm.rnn.proj.weight, tm.layers[0].weight, tm.head.weight,
            pm.layers[0].weight, pm.head.weight]
    affine = [rm.mlp.norms[0].scale, rm.mlp.norms[0].offset, rm.rnn.norm.scale, rm.rnn.norm.offset,
              tm.norms[0].scale, tm.norms[0].offset, tm.head.bias, pm.norms[0].scale, pm.norms[0].offset,
              pm.head.bias]
    assert sum(m.numel() for m in mats) / 1e6 == pytest.approx(millions, abs=0.005)
    weights = [jnp.asarray(m.detach().numpy(), dtype) for m in mats]
    weights += [jnp.asarray(t.detach().numpy()) for t in affine]  # the LN affines and biases stay f32
    assert fused_rssm_supported("silu", *weights) == fits
