"""DroQ in the port (`nn/blocks.py:MLP` and `StackedMLP` with dropout,
`algos/droq/`) against the reference `sheeprl_tpu` on the CPU, at small
sizes (obs 3, act 1, width 16, 2 critics), every draw teacher-forced: the
dropout masks are the reference's `bernoulli(key, keep)`, which is
`uniform(key) < keep`, so the port is given the uniforms rebuilt from the
reference's key tree:

  - the dropout MLP (Linear -> dropout -> LayerNorm -> ReLU) and the
    dropout critic ensemble (each member its own masks) at atol 1e-6;
  - one DroQ train step at G = 2, B = 8 against the reference's
    `make_train_step` (the critic rounds' target noise and both masks, the
    actor's noise and masks on its fresh batch): every parameter, the
    target critics, `log_alpha`, the three Adam states and the losses at
    atol 2e-6 (moments 1e-6 / rtol 1e-4);
  - `droq --device cpu` at tiny widths: checkpoints with SAC's keys, a
    resume at `global_step + 1`, `--eval_only`.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_interop import jax_flat
from tests.test_torch_sac_train import (
    ACT, B, G, HIDDEN, N_CRITICS, OBS, TINY, _t, assert_adams_match, assert_agents_match, batch, done_record,
    port_agent, ref_agent,
)

LAYERS, DROPOUT = 2, 0.2


def mlp_uniforms(key, b: int, hidden: int, layers: int = LAYERS) -> np.ndarray:
    """The uniforms of the reference MLP's dropout draws from `key`
    (`sheeprl_tpu/nn/blocks.py:101-103`: `key, sub = split(key)` a layer)."""
    out = []
    for _ in range(layers):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (b, hidden), jnp.float32)))
    return np.stack(out)


def ensemble_uniforms(key, n: int, b: int, hidden: int) -> np.ndarray:
    """[layers, n, B, hidden]: the ensemble splits `key` into one a member
    (`sheeprl_tpu/algos/droq/agent.py:70-73`)."""
    return np.stack([mlp_uniforms(k, b, hidden) for k in jax.random.split(key, n)], axis=1)


def test_dropout_mlp_matches_the_reference():
    from sheeprl_tpu.nn.blocks import MLP as RefMLP
    from sheeprl_tpu_torch.interop import load_jax_params
    from sheeprl_tpu_torch.nn.blocks import MLP

    ref = RefMLP.init(jax.random.PRNGKey(0), 5, [HIDDEN, HIDDEN], 2, act="relu", layer_norm=True,
                      dropout_rate=DROPOUT)
    port = load_jax_params(MLP(5, [HIDDEN, HIDDEN], 2, act="relu", layer_norm=True, dropout_rate=DROPOUT),
                           jax_flat(ref))
    x = np.random.default_rng(0).normal(size=(32, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(ref(jnp.asarray(x), key=key, training=True))
    u = mlp_uniforms(key, 32, HIDDEN)
    # the masks really drop: about DROPOUT of the units
    assert 0.1 < float((u >= 1 - DROPOUT).mean()) < 0.3
    with torch.no_grad():
        got = port(_t(x), list(_t(u))).numpy()
        plain = port(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(plain, np.asarray(ref(jnp.asarray(x))), atol=1e-6, rtol=0)


def test_dropout_ensemble_matches_the_reference():
    ref = ref_agent("droq", dropout=DROPOUT)
    port = port_agent(ref, "droq", dropout=DROPOUT)
    data = batch(lead=(32,))
    key = jax.random.PRNGKey(4)
    want = np.asarray(ref.critics(jnp.asarray(data["observations"]), jnp.asarray(data["actions"]), key=key,
                                  training=True))
    u = ensemble_uniforms(key, N_CRITICS, 32, HIDDEN)
    with torch.no_grad():
        got = port.critics(_t(data["observations"]), _t(data["actions"]), list(_t(u))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert tuple(port.critics.members.model.norms[0].scale.shape) == (N_CRITICS, HIDDEN)


def droq_draws_of(key, g: int, b: int) -> dict[str, np.ndarray]:
    """Every draw of the reference's DroQ step (droq.py:67-100) from its
    key: the critic rounds' (`split(k_scan, G)`, each `k_target, k_drop`,
    the target's `k_pi, k_drop`) and the actor update's (`k_pi`,
    `k_drop`)."""
    _, k_scan, k_pi, k_drop = jax.random.split(key, 4)
    target, target_masks, critic_masks = [], [], []
    for k in jax.random.split(k_scan, g):
        k_target, k_drop_c = jax.random.split(k)
        k_pi_t, k_drop_t = jax.random.split(k_target)
        target.append(np.asarray(jax.random.normal(k_pi_t, (b, ACT), jnp.float32)))
        target_masks.append(ensemble_uniforms(k_drop_t, N_CRITICS, b, HIDDEN))
        critic_masks.append(ensemble_uniforms(k_drop_c, N_CRITICS, b, HIDDEN))
    return {"target": np.stack(target), "actor": np.asarray(jax.random.normal(k_pi, (b, ACT), jnp.float32)),
            "target_masks": np.stack(target_masks), "critic_masks": np.stack(critic_masks),
            "actor_masks": ensemble_uniforms(k_drop, N_CRITICS, b, HIDDEN)}


def test_one_droq_train_step_matches_the_reference():
    from sheeprl_tpu.algos.droq.args import DROQArgs as RefArgs
    from sheeprl_tpu.algos.droq.droq import TrainState, make_train_step as ref_step
    from sheeprl_tpu.algos.sac.sac import make_optimizers as ref_optimizers
    from sheeprl_tpu_torch.algos.droq.args import DROQArgs
    from sheeprl_tpu_torch.algos.droq.droq import droq_draws, make_train_step
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainState, make_optimizers

    kw = dict(gradient_steps=G, per_rank_batch_size=B, num_critics=N_CRITICS, actor_hidden_size=HIDDEN,
              critic_hidden_size=HIDDEN, gamma=0.97, dropout=DROPOUT)
    ref_args, args = RefArgs(**kw), DROQArgs(**kw, device="cpu")
    ref = ref_agent("droq", dropout=DROPOUT)
    port = port_agent(ref, "droq", dropout=DROPOUT)
    qf, actor, alpha = ref_optimizers(ref_args)
    ref_state = TrainState(agent=ref, qf_opt=qf.init(ref.critics), actor_opt=actor.init(ref.actor),
                           alpha_opt=alpha.init(ref.log_alpha))
    data, actor_batch = batch(), batch(seed=2, lead=(B,))
    key = jax.random.PRNGKey(9)
    ref_state, metrics = ref_step(ref_args, qf, actor, alpha)(
        ref_state, {k: jnp.asarray(v) for k, v in data.items()},
        {k: jnp.asarray(v) for k, v in actor_batch.items()}, key)

    state = SACTrainState(port, *make_optimizers(args, port))
    layout = droq_draws(args, ACT)
    losses = make_train_step(args, layout)(state, {k: _t(v) for k, v in data.items()},
                                           layout.pack(droq_draws_of(key, G, B)), _t(actor_batch["observations"]))
    assert_agents_match(port, ref_state.agent, atol=2e-6)
    assert_adams_match(state, ref_state, atol=1e-6, rtol=1e-4)
    want = [float(metrics[k]) for k in ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")]
    np.testing.assert_allclose(losses.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def droq_run(tmp_path_factory):
    from sheeprl_tpu_torch.cli import run

    root = tmp_path_factory.mktemp("droq")
    run(["droq", *TINY, "--gradient_steps", "2", "--total_steps", "40", "--checkpoint_every", "20",
         "--root_dir", str(root), "--run_name", "r"])
    return str(root / "r")


def test_droq_cli_trains_checkpoints_resumes_and_evaluates(droq_run, tmp_path):
    import shutil

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    rec = done_record(droq_run)
    assert rec["algo"] == "droq" and rec["env_steps"] == 40
    assert rec["train_calls"] == 16 + (40 - 15) and rec["gradient_steps"] == 2 * rec["train_calls"]
    ckpt = load_checkpoint(os.path.join(droq_run, "checkpoints", "ckpt_40"))
    assert set(ckpt) == {"agent", "qf_optimizer", "actor_optimizer", "alpha_optimizer", "global_step", "generator"}
    assert "members.model.norms.0.scale" in ckpt["agent"]["critics"]
    losses = [r for r in map(json.loads, open(os.path.join(droq_run, "metrics.jsonl"))) if "Loss/value_loss" in r]
    assert losses and all(np.isfinite(r["Loss/value_loss"]) for r in losses)

    run_dir = str(tmp_path / "r")
    shutil.copytree(droq_run, run_dir)
    run(["droq", "--checkpoint_path", os.path.join(run_dir, "checkpoints", "ckpt_20"), "--device", "cpu"])
    rec = done_record(run_dir)
    assert rec["resumed"]["start_step"] == 21 and rec["env_steps"] == 20
    assert rec["train_calls"] == 16 + (40 - 36)  # re-collected to 36 = 16 + 21 - 1, the burst there

    run(["droq", "--eval_only", "--checkpoint_path", os.path.join(droq_run, "checkpoints", "ckpt_40"),
         "--test_episodes", "2", "--device", "cpu", "--root_dir", str(tmp_path), "--run_name", "e"])
    rec = done_record(str(tmp_path / "e"))
    assert rec["train_calls"] == 0 and len(rec["test_returns"]) == 2
