"""The port's DreamerV3 player against the reference's, at tiny widths (64x64x3
pixels plus one vector key, discrete actions), weights carried across by
`interop`.

The served step samples the posterior even in evaluation: the reference
draws it with `jax.random.categorical(k_repr, logits)`, which is
`argmax(jax.random.gumbel(k_repr, logits.shape) + logits)`. The test draws
that Gumbel noise with the reference's key, checks once that it reproduces
the reference's own draw, and feeds the same noise to the port's step.
Recurrent and stochastic states agree to atol 1e-5; actions exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_interop import TINY_DV3, tiny_players

ATOL = 1e-5
S, D = TINY_DV3["stochastic_size"], TINY_DV3["discrete_size"]


def _obs(rng, batch):
    return {
        "rgb": rng.random((batch, 64, 64, 3), dtype=np.float32),
        "state": rng.normal(size=(batch, 5)).astype(np.float32),
    }


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_init_states_agree():
    jplayer, tplayer = tiny_players()
    js, ts = jplayer.init_states(4), tplayer.init_states(4)
    _close(ts.actions, js.actions)
    _close(ts.recurrent_state, js.recurrent_state)
    _close(ts.stochastic_state, js.stochastic_state)


def test_three_chained_steps_agree_with_injected_noise():
    jplayer, tplayer = tiny_players()
    rng = np.random.default_rng(0)
    batch = 3
    js, ts = jplayer.init_states(batch), tplayer.init_states(batch)
    for t in range(3):
        obs = _obs(rng, batch)
        key = jax.random.PRNGKey(100 + t)
        k_repr = jax.random.split(key, 3)[0]
        gumbel = jax.random.gumbel(k_repr, (batch, S, D))
        jobs = {k: jnp.asarray(v) for k, v in obs.items()}
        if t == 0:
            # the injected noise is the reference's own draw
            recurrent = jplayer.rssm.recurrent_model(
                jnp.concatenate([js.stochastic_state, js.actions], axis=-1), js.recurrent_state
            )
            logits, sample = jplayer.rssm._representation(recurrent, jplayer.encoder(jobs), key=k_repr)
            mine = jnp.argmax(gumbel + logits.reshape(batch, S, D), axis=-1)
            np.testing.assert_array_equal(np.asarray(mine), np.asarray(jnp.argmax(sample, axis=-1)))
        js, jact = jplayer.step(js, jobs, key, jnp.float32(0.0), is_training=False)
        with torch.inference_mode():
            ts, tact = tplayer.step(
                ts, {k: torch.from_numpy(v) for k, v in obs.items()},
                gumbel=torch.from_numpy(np.array(gumbel)), is_training=False,
            )
        _close(ts.recurrent_state, js.recurrent_state)
        _close(ts.stochastic_state, js.stochastic_state)
        np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
        np.testing.assert_array_equal(ts.actions.numpy(), np.asarray(js.actions))


def test_exploration_actions_keep_one_hot_rows():
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import exploration_actions

    acts = (torch.eye(3)[[0, 2, 1, 1]], torch.eye(2)[[1, 0, 0, 1]])
    torch.testing.assert_close(exploration_actions(acts, False, 0.0), torch.cat(acts, -1))
    noisy = exploration_actions(acts, False, 1.0, torch.Generator().manual_seed(0))
    assert torch.equal(noisy[:, :3].sum(-1), torch.ones(4))
    assert torch.equal(noisy[:, 3:].sum(-1), torch.ones(4))


def test_bfloat16_step_follows_the_compute_dtype():
    """`--precision bfloat16`: obs, states and the kernels' inputs run in
    bf16 (LN statistics and the action heads stay f32); the step stays
    within bf16 rounding of the f32 step."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3

    _, f32 = tiny_players()
    bf16 = PlayerDV3(
        f32.encoder, f32.rssm, f32.actor, actions_dim=f32.actions_dim,
        stochastic_size=S, discrete_size=D, recurrent_state_size=f32.recurrent_state_size,
        compute_dtype="bfloat16",
    )
    obs = {k: torch.from_numpy(v) for k, v in _obs(np.random.default_rng(1), 2).items()}
    gumbel = torch.from_numpy(np.random.default_rng(2).gumbel(size=(2, S, D)).astype(np.float32))
    with torch.inference_mode():
        s32, _ = f32.step(f32.init_states(2), obs, gumbel=gumbel, is_training=False)
        s16, acts = bf16.step(bf16.init_states(2), obs, gumbel=gumbel, is_training=False)
    assert s16.recurrent_state.dtype == s16.stochastic_state.dtype == torch.bfloat16
    assert acts.dtype == torch.float32 and torch.equal(acts.sum(-1), torch.ones(2))
    torch.testing.assert_close(s16.recurrent_state.float(), s32.recurrent_state, atol=5e-2, rtol=0)
