"""DreamerV3 with continuous actions: the port against the reference at tiny
widths on the CPU.

  - the distributions (`TruncatedNormal`, `TanhNormal`, and the maps of
    uniform floats to the reference's draws, `open_uniform` and
    `standard_normal`);
  - the actor for `trunc_normal`, `tanh_normal` and `normal`: its
    distributions, its training sample and its best-of-100 evaluation;
  - the player on `continuous_dummy`: `noisy_step` and the greedy `step`;
  - one whole `make_train_step` on `continuous_dummy` pixels and on
    Pendulum-v1's vector, the actor's gradient leaf by leaf through the
    imagined steps;
  - the `--env_backend jax` collector on the device Pendulum, teacher-forced;
  - a reference checkpoint of a continuous DreamerV3 through `interop`;
  - the port's CLI runs (training on both env backends, `--eval_only`,
    `serve --device cpu`), and the discrete path unchanged.

Every draw is rebuilt from the reference's key tree, as in
tests/test_torch_dv3_train.py and tests/test_torch_anakin.py. A continuous
draw of the reference maps the floats `jax.random.uniform(key, shape)` (in
[0, 1)); the port takes those floats and maps them the same way, so the
test feeds it the reference's floats.

Tolerances, each where it is used:

  - Samples (`_sample_gap`): a truncated-normal sample is the icdf `loc + scale *
    sqrt(2) erfinv(2 (Phi(a) + p Z) - 1)`. Both sides compute Phi in f32,
    a few ulps of 1 apart, and the icdf multiplies a difference dPhi by
    `scale / phi(z)`, steep at the ends (p near eps or 1 - eps). A sample
    is held at `1e-5 + 8 eps scale / phi(z)` (eight f32 ulps of 1 in the
    cdf through the icdf's slope at the reference's sample; the largest
    measured was 3.2 ulps); the worst gap at the ends is printed. A
    standard normal draw the same way: `1e-6 + 8 eps sqrt(pi/2)
    exp(z^2 / 2)`.
  - Log-probabilities, entropies, means and modes: rtol 1e-5, atol 1e-5.
  - The player's states: atol 1e-5; its actions as the samples.
  - The gradient step: the 13 metrics at rtol 1e-3, atol 1e-4, the world
    model and the critic after one Adam step at atol 2 lr + 1e-6, the
    target critic at 1e-6 (tests/test_torch_dv3_train.py's). The actor
    steps by SGD at lr 1 behind the reference's clip on both sides, so its
    parameter change is minus its clipped gradient; each leaf's change is
    held at 1e-3 of that leaf's largest magnitude.
  - The collector: trajectory, carry and player state at rtol/atol 1e-4
    (the actions' samples pass through the env for 16 steps); flags and
    the pixels-free episode count exactly.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_anakin import _fresh, _stack, _tiny_uniform, _venvs
from tests.test_torch_interop import TINY_DV3, jax_flat

EPS = float(np.finfo(np.float32).eps)
ATOL = RTOL = 1e-5
N_ROWS = 64


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, what: str, rtol: float = RTOL, atol: float = ATOL) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _sample_gap(got, want, loc, scale, what: str) -> float:
    """A truncated-normal sample against the reference's at `1e-5 + 8 eps
    scale / phi(z)`; -> the largest gap in f32 ulps of 1 through the
    icdf's slope."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    z = (want - np.asarray(loc, np.float64)) / np.asarray(scale, np.float64)
    slope = np.asarray(scale, np.float64) / np.maximum(np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi), 1e-300)
    gap = np.abs(got - want)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    bad = gap > 1e-5 + 8 * EPS * slope
    assert not bad.any(), f"{what}: {int(bad.sum())} samples past the tolerance, worst gap {gap.max():.3e}"
    return float((gap / (EPS * slope)).max())


def _normal_gap(got, want, what: str) -> None:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    tol = 1e-6 + 8 * EPS * math.sqrt(math.pi / 2) * np.exp(np.minimum(want * want / 2, 600))
    gap = np.abs(got - want)
    assert (gap <= tol).all(), f"{what}: worst gap {gap.max():.3e}"


def _actor_like(seed: int, n: int = N_ROWS, a: int = 3):
    """loc and scale of a truncated-normal actor's rows: tanh of a normal
    mean, 2 sigmoid(std / 2) + 0.1."""
    g = np.random.default_rng(seed)
    loc = np.tanh(g.normal(size=(n, a)) * 1.5).astype(np.float32)
    scale = (2 / (1 + np.exp(-g.normal(size=(n, a)) * 1.5)) + 0.1).astype(np.float32)
    return loc, scale


# ---------------------------------------------------------------------------
# the distributions
# ---------------------------------------------------------------------------


def _truncated_pair(seed: int):
    from sheeprl_tpu.ops import distributions as R
    from sheeprl_tpu_torch.ops import distributions as P

    loc, scale = _actor_like(seed)
    one = np.ones_like(loc)
    ref = R.TruncatedNormal(loc=jnp.asarray(loc), scale=jnp.asarray(scale), low=-jnp.asarray(one),
                            high=jnp.asarray(one))
    port = P.TruncatedNormal(_t(loc), _t(scale), -_t(one), _t(one))
    return ref, port, loc, scale


def test_uniform_floats_map_to_the_references_draws():
    """`open_uniform` and `standard_normal` of the floats under
    `jax.random.uniform(key, shape)` are the reference's
    `uniform(minval=eps, maxval=1-eps)` (to an f32 ulp) and
    `jax.random.normal` (at the normal tolerance) of the same key."""
    from sheeprl_tpu_torch.ops.distributions import open_uniform, standard_normal

    key = jax.random.PRNGKey(3)
    floats = np.asarray(jax.random.uniform(key, (100, N_ROWS, 3)))
    want = np.asarray(jax.random.uniform(key, (100, N_ROWS, 3), minval=EPS, maxval=1 - EPS))
    _close(open_uniform(_t(floats)), want, "open_uniform", rtol=0, atol=EPS / 2)
    _normal_gap(standard_normal(_t(floats)), jax.random.normal(key, (100, N_ROWS, 3)), "standard_normal")
    ends = _t(np.array([0.0, 1 - 2.0 ** -23], np.float32))
    assert open_uniform(ends).tolist() == pytest.approx([EPS, 1 - 2 * EPS], abs=0)
    assert torch.isfinite(standard_normal(ends)).all()


def test_truncated_normal_matches_the_reference():
    ref, port, loc, scale = _truncated_pair(0)
    key = jax.random.PRNGKey(4)
    floats = np.asarray(jax.random.uniform(key, (100, N_ROWS, 3)))
    want = np.asarray(ref.sample(key, (100,)))
    bulk = _sample_gap(port.sample(_t(floats)), want, loc, scale, "sample")
    _close(port.log_prob(_t(want)), ref.log_prob(jnp.asarray(want)), "log_prob")
    _close(port.entropy(), ref.entropy(), "entropy")
    _close(port.mean, ref.mean, "mean")
    _close(port.mode, ref.mode, "mode")
    z = (want - loc) / scale
    _close(port._std().cdf(_t(z.astype(np.float32))), ref._std().cdf(jnp.asarray(z, jnp.float32)), "cdf")
    # the ends: the floats 0 and 1 - 2^-23 (p = eps and 1 - 2 eps, the
    # widest the draw gives), and the icdf at p = eps and 1 - eps exactly
    worst = {}
    for raw in (0.0, 1 - 2.0 ** -23):
        floats = np.full(loc.shape, raw, np.float32)
        p = np.maximum(np.float32(EPS), floats * np.float32(1 - 2 * EPS) + np.float32(EPS))
        want = np.asarray(ref._std().icdf(jnp.asarray(p)) * ref.scale + ref.loc)
        worst[f"floats {raw!r}"] = _sample_gap(port.sample(_t(floats)), want, loc, scale, f"sample at {raw}")
    for p in (EPS, 1 - EPS):
        want = np.asarray(ref._std().icdf(jnp.full(loc.shape, p, jnp.float32)) * ref.scale + ref.loc)
        got = port._std().icdf(torch.full(loc.shape, p)) * port.scale + port.loc
        worst[f"p {p!r}"] = _sample_gap(got, want, loc, scale, f"icdf at {p}")
    print(f"truncated normal: worst gap in the bulk {bulk:.2f} f32 ulps of the cdf, at the ends "
          + ", ".join(f"{k}: {v:.2f}" for k, v in worst.items()))


def test_tanh_normal_matches_the_reference():
    from sheeprl_tpu.ops import distributions as R
    from sheeprl_tpu_torch.ops import distributions as P

    loc, scale = _actor_like(1)
    loc = 5.0 * np.tanh(loc * 3 / 5.0).astype(np.float32)
    ref, port = R.TanhNormal(loc=jnp.asarray(loc), scale=jnp.asarray(scale)), P.TanhNormal(_t(loc), _t(scale))
    key = jax.random.PRNGKey(5)
    floats = np.asarray(jax.random.uniform(key, (100, N_ROWS, 3)))
    want = ref.sample(key, (100,))
    _close(port.sample(_t(floats)), want, "sample")
    _close(port.log_prob(_t(np.asarray(want))), ref.log_prob(want), "log_prob", rtol=1e-5, atol=1e-4)
    _close(port.mode, ref.mode, "mode")
    _close(port.mean, ref.mean, "mean")
    # the ends of the floats: draws at -5.4 and +5.3 standard deviations
    for raw in (0.0, 1 - 2.0 ** -23):
        f = np.full(loc.shape, raw, np.float32)
        x = loc + scale * np.asarray(jnp.sqrt(2.0) * jax.lax.erf_inv(jnp.maximum(
            np.nextafter(np.float32(-1), np.float32(0)), jnp.asarray(f) * 2.0 + np.nextafter(np.float32(-1),
                                                                                             np.float32(0)))))
        _close(port.sample(_t(f)), np.tanh(x), f"sample at {raw}")


# ---------------------------------------------------------------------------
# the actor
# ---------------------------------------------------------------------------

LATENT = 24


def _actors(distribution: str, actions: int = 3):
    """(the reference's continuous actor, the port's with its parameters);
    a `normal` actor's std head is lifted by 3 so its raw std is positive
    (the reference feeds it to the Normal unsquashed)."""
    from sheeprl_tpu.algos.dreamer_v3.agent import Actor as RefActor
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor
    from sheeprl_tpu_torch.interop import load_jax_params

    kw = dict(dense_units=16, mlp_layers=2, distribution=distribution, init_std=0.0, min_std=0.1)
    ref = RefActor.init(jax.random.PRNGKey(2), LATENT, [actions], True, **kw)
    if distribution == "normal":
        head = ref.heads[0]
        ref = ref.replace(heads=(head.replace(bias=head.bias.at[actions:].add(3.0)),))
    port = Actor(LATENT, [actions], True, generator=torch.Generator().manual_seed(0), **kw)
    load_jax_params(port, jax_flat(ref))
    assert port.distribution == ("trunc_normal" if distribution == "auto" else distribution)
    return ref, port


def _locscale(port, state):
    d = port.dists(state)[0]
    base = d.base if hasattr(d, "base") else d
    return base.loc.detach().numpy(), base.scale.detach().numpy()


@pytest.mark.parametrize("distribution", ["auto", "tanh_normal", "normal"])
def test_actor_matches_the_reference(distribution):
    ref, port = _actors(distribution)
    rng = np.random.default_rng(7)
    state = rng.normal(size=(8, LATENT)).astype(np.float32)
    jd, pd = ref.dists(jnp.asarray(state))[0], port.dists(_t(state))[0]
    _close(pd.mean, jd.mean, "mean")
    _close(pd.mode, jd.mode, "mode")
    if distribution != "tanh_normal":
        _close(pd.entropy(), jd.entropy(), "entropy")
    key = jax.random.PRNGKey(8)
    (j_act,), _ = ref(jnp.asarray(state), key=key, is_training=True)
    (p_act,), _ = port(_t(state), is_training=True, uniforms=_t(jax.random.uniform(key, (8, 3))))
    (j_best,), _ = ref(jnp.asarray(state), key=key, is_training=False)
    (p_best,), _ = port(_t(state), is_training=False, uniforms=_t(jax.random.uniform(key, (100, 8, 3))))
    _close(pd.log_prob(_t(np.asarray(j_act))), jd.log_prob(j_act), "log_prob", atol=1e-4)
    if distribution == "auto":  # the truncated normal's icdf
        loc, scale = _locscale(port, _t(state))
        _sample_gap(p_act, j_act, loc, scale, "training sample")
        _sample_gap(p_best, j_best, loc, scale, "best of 100")
    else:
        _close(p_act, j_act, "training sample")
        _close(p_best, j_best, "best of 100")
    # the best of 100 is the likeliest candidate, and not the first
    cands = port._sample(pd, _t(jax.random.uniform(key, (100, 8, 3))))
    best = pd.log_prob(cands).argmax(0)
    assert torch.equal(p_best, cands[best, torch.arange(8)]) and best.unique().numel() > 1


def test_discrete_distribution_on_a_continuous_space_is_refused():
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor

    with pytest.raises(ValueError, match="discrete distribution chosen"):
        Actor(LATENT, [2], True, distribution="discrete")
    with pytest.raises(ValueError, match="given uniforms"):
        Actor(LATENT, [2], True)(torch.zeros(1, LATENT))


# ---------------------------------------------------------------------------
# the player
# ---------------------------------------------------------------------------

S, D = TINY_DV3["stochastic_size"], TINY_DV3["discrete_size"]
A_DUMMY = 2


def _continuous_models(obs: str, seed: int = 0, **overrides):
    """Both packages' tiny continuous models, the port's carrying the
    reference's parameters: `pixels` (continuous_dummy's 64x64 rgb, 2
    actions) or `vector` (Pendulum-v1's 3-vector `state`, 1 action); the
    config's fields `overrides`. -> (ref (wm, actor, critic, target), port
    (...), keys, actions, the config's fields)."""
    import gymnasium as gym

    from sheeprl_tpu.algos.dreamer_v3.agent import build_models as ref_build
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args as RefArgs
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop import load_jax_params

    tiny = dict(TINY_DV3, per_rank_batch_size=2, per_rank_sequence_length=4, horizon=3, **overrides)
    if obs == "pixels":
        keys, actions = (["rgb"], []), A_DUMMY
        jspace, tspace = ({"rgb": gym.spaces.Box(0, 255, (64, 64, 3), np.uint8)},
                          {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)})
    else:
        keys, actions = ([], ["state"]), 1
        jspace = {"state": gym.spaces.Box(-np.inf, np.inf, (3,), np.float32)}
        tspace = {"state": spaces.Box(-np.inf, np.inf, (3,))}
    ref = ref_build(jax.random.PRNGKey(seed), [actions], True, RefArgs(**tiny), jspace, *keys)
    port = build_models(torch.Generator().manual_seed(1), [actions], True, DreamerV3Args(**tiny), tspace, *keys)
    for r, p in zip(ref, port):
        load_jax_params(p, jax_flat(r))
    return ref, port, keys, actions, tiny


def _players(obs: str = "pixels"):
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerDV3 as RefPlayer
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3

    (jwm, jactor, _, _), (twm, tactor, _, _), _, actions, _ = _continuous_models(obs)
    common = dict(stochastic_size=S, discrete_size=D, recurrent_state_size=TINY_DV3["recurrent_state_size"],
                  is_continuous=True)
    jplayer = RefPlayer(encoder=jwm.encoder, rssm=jwm.rssm, actor=jactor, actions_dim=(actions,), **common)
    tplayer = PlayerDV3(twm.encoder, twm.rssm, tactor, actions_dim=(actions,), **common)
    return jplayer, tplayer, actions


def _step_draws(key, n: int, actions: int, training: bool) -> dict:
    """`PlayerDV3.step`'s draws of one key (agent.py:820: `split(key, 3)`
    into the posterior's, the actor's and the exploration's): the
    posterior's Gumbels' uniforms, then the actor's floats ([n, A], or
    [100, n, A] for the best of 100) and the exploration normals' floats."""
    k_repr, k_act, k_expl = jax.random.split(key, 3)
    post = _tiny_uniform(k_repr, (n, S, D))
    if training:
        act = np.asarray(jax.random.uniform(k_act, (n, actions)))
        expl = np.asarray(jax.random.uniform(k_expl, (n, actions)))
        return {"uniform": _t(np.concatenate([post.reshape(n, S * D), act, expl], -1))}
    return {"gumbel": _t(jax.random.gumbel(k_repr, (n, S, D))),
            "uniforms": _t(jax.random.uniform(k_act, (100, n, actions)))}


@pytest.mark.parametrize("mode", ["noisy_step", "step"])
def test_player_matches_the_reference_on_continuous_dummy(mode):
    jplayer, tplayer, actions = _players()
    training = mode == "noisy_step"
    n, expl = 3, 0.3
    rng = np.random.default_rng(0)
    js, ts = jplayer.init_states(n), tplayer.init_states(n)
    assert tplayer.noise_width() == S * D + 2 * actions
    for t in range(3):
        obs = {"rgb": rng.integers(0, 256, (n, 64, 64, 3)).astype(np.float32) / 255.0}
        key = jax.random.PRNGKey(200 + t)
        js, jact = jplayer.step(js, {k: jnp.asarray(v) for k, v in obs.items()}, key,
                                jnp.float32(expl if training else 0.0), is_training=training)
        draws = _step_draws(key, n, actions, training)
        with torch.inference_mode():
            tobs = {k: _t(v) for k, v in obs.items()}
            if training:
                ts, tact = tplayer.noisy_step(ts, tobs, draws["uniform"], torch.tensor(expl))
            else:
                ts, tact = tplayer.step(ts, tobs, gumbel=draws["gumbel"], uniforms=draws["uniforms"])
        _close(ts.recurrent_state, js.recurrent_state, f"recurrent state {t}")
        _close(ts.stochastic_state, js.stochastic_state, f"stochastic state {t}")
        _close(tact, jact, f"actions {t}", atol=1e-4)
        _close(ts.actions, js.actions, f"state actions {t}", atol=1e-4)
        assert tact.abs().max() <= 1.0


def test_continuous_exploration_takes_its_normals_at_every_amount():
    """`clip(a + amount * n, -1, 1)` with the normals given, the amount a
    device scalar: at 0 the actions are clipped, not skipped."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import exploration_actions

    acts = (torch.tensor([[0.5, -1.5], [2.0, 0.1]]),)
    noise = torch.tensor([[1.0, -1.0], [-3.0, 0.5]])
    torch.testing.assert_close(exploration_actions(acts, True, torch.tensor(0.0), noise=noise),
                               torch.tensor([[0.5, -1.0], [1.0, 0.1]]))
    torch.testing.assert_close(exploration_actions(acts, True, torch.tensor(0.5), noise=noise),
                               torch.tensor([[1.0, -1.0], [0.5, 0.35]]))


# ---------------------------------------------------------------------------
# one gradient step, the actor's gradient through imagination
# ---------------------------------------------------------------------------

T, B, H = 4, 2, 3
KEY_SEED = 7


def _batch(obs: str, actions: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(0)
    dones = np.zeros((T, B, 1), np.float32)
    is_first = np.zeros((T, B, 1), np.float32)
    dones[1, 0] = 1.0  # an episode ends inside the window and the next one starts
    is_first[2, 0] = 1.0
    batch = {
        "actions": rng.uniform(-1, 1, (T, B, actions)).astype(np.float32),
        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32),
        "dones": dones,
        "is_first": is_first,
    }
    if obs == "pixels":
        batch["rgb"] = rng.integers(0, 255, (T, B, 64, 64, 3), dtype=np.uint8)
    else:
        batch["state"] = rng.normal(size=(T, B, 3)).astype(np.float32)
    return batch


def _noise(key, actions: int) -> dict:
    """The reference step's draws, rebuilt from its key tree
    (dreamer_v3.py:172, 292, 298-302; a continuous actor samples its key's
    floats whole, agent.py:662-664): the posteriors' and the imagined
    priors' Gumbels, the imagined actions' floats [H+1, T*B, A]."""
    k_wm, k_img = jax.random.split(key)
    post = [jax.random.gumbel(jax.random.split(k)[1], (B, S, D)) for k in jax.random.split(k_wm, T)]
    img_keys = jax.random.split(k_img, H + 1)
    prior, acts = [], []
    for h in range(H):
        k_act, k_trans = jax.random.split(img_keys[h])
        acts.append(jax.random.uniform(k_act, (T * B, actions)))
        prior.append(jax.random.gumbel(k_trans, (T * B, S, D)))
    acts.append(jax.random.uniform(img_keys[H], (T * B, actions)))
    t = lambda xs: _t(jnp.stack(xs))  # noqa: E731
    return {"post": t(post), "img_prior": t(prior), "img_actions": t(acts)}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("obs", ["pixels", "vector"])
def test_train_step_matches_the_reference_with_the_actor_gradient(obs):
    """The Hafner initialization zeroes the critic's and the reward head's
    output layers, and then no gradient reaches the actor through the
    imagined values; both cases build without it (Xavier-normal
    everywhere, in both packages), so the actor's gradient is the one
    through imagination. On vector obs the entropy bonus is off as well, so
    imagination is the whole of it."""
    import optax

    from sheeprl_tpu import ops
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args as RefArgs
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import DV3TrainState as RefState
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_optimizers as ref_optimizers
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as ref_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRICS, DV3TrainState, make_optimizers, make_train_step
    from sheeprl_tpu_torch.interop import state_dict_from_jax
    from sheeprl_tpu_torch.ops.moments import Moments

    overrides = dict(hafner_initialization=False, actor_ent_coef=0.0 if obs == "vector" else 3e-4)
    ref, port, (cnn_keys, mlp_keys), actions, tiny = _continuous_models(obs, **overrides)
    # the reference's step: Adams for the world model and the critic, SGD at
    # lr 1 behind the same clip for the actor
    rargs = RefArgs(**tiny)
    wopt, _, copt = ref_optimizers(rargs)
    aopt = optax.chain(optax.clip_by_global_norm(rargs.actor_clip_gradients), optax.sgd(1.0))
    jwm, jactor, jcritic, jtarget = ref
    state = RefState(world_model=jwm, actor=jactor, critic=jcritic, target_critic=jtarget, world_opt=wopt.init(jwm),
                     actor_opt=aopt.init(jactor), critic_opt=copt.init(jcritic),
                     moments=ops.Moments.init(rargs.moments_decay, rargs.moment_max, rargs.moments_percentile_low,
                                              rargs.moments_percentile_high))
    before = {name: jax_flat(getattr(state, name)) for name in ("world_model", "actor", "critic", "target_critic")}
    step = ref_train_step(rargs, wopt, aopt, copt, cnn_keys, mlp_keys, [actions], True)
    batch = _batch(obs, actions)
    new_state, ref_metrics = step(jax.tree_util.tree_map(jnp.copy, state), {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(KEY_SEED), jnp.float32(1.0))
    after = {name: jax_flat(getattr(new_state, name)) for name in before}
    ref_metrics = {k: float(v) for k, v in ref_metrics.items()}

    args = DreamerV3Args(**tiny)
    wm, actor, critic, target = port
    world_opt, _, critic_opt = make_optimizers(args, wm, actor, critic)
    pstate = DV3TrainState(wm, actor, critic, target, world_opt, torch.optim.SGD(actor.parameters(), lr=1.0),
                           critic_opt, Moments(args.moments_decay, args.moment_max, args.moments_percentile_low,
                                               args.moments_percentile_high))
    metrics = make_train_step(args, cnn_keys, mlp_keys, [actions], True)(
        pstate, {k: torch.from_numpy(v) for k, v in batch.items()}, 1.0, _noise(jax.random.PRNGKey(KEY_SEED), actions))

    assert set(metrics) == set(ref_metrics) == set(METRICS)
    for name in METRICS:
        np.testing.assert_allclose(metrics[name], ref_metrics[name], rtol=1e-3, atol=1e-4, err_msg=name)
    np.testing.assert_allclose([float(pstate.moments.low), float(pstate.moments.high)],
                               [float(new_state.moments.low), float(new_state.moments.high)], rtol=1e-3, atol=1e-5)
    lrs = {"world_model": args.world_lr, "critic": args.critic_lr}
    for name, module in (("world_model", wm), ("critic", critic), ("target_critic", target)):
        atol = 2 * lrs[name] + 1e-6 if name in lrs else 1e-6
        got, want = module.state_dict(), state_dict_from_jax(module, after[name])
        for path in got:
            np.testing.assert_allclose(got[path].numpy(), want[path].numpy(), rtol=0, atol=atol,
                                       err_msg=f"{name}.{path}")
    # the actor: its parameter change is minus its clipped gradient, held
    # leaf by leaf at 1e-3 of the leaf's largest magnitude
    got, want = actor.state_dict(), state_dict_from_jax(actor, after["actor"])
    start = state_dict_from_jax(actor, before["actor"])
    worst = {}
    for path in got:
        g_port, g_ref = (start[path] - got[path]).numpy(), (start[path] - want[path]).numpy()
        scale = float(np.abs(g_ref).max())
        assert scale > 0, f"actor.{path}: no gradient reached it"
        worst[path] = float(np.abs(g_port - g_ref).max()) / scale
    print(f"{obs}: the actor's gradient, largest gap over the leaf's largest magnitude: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    assert max(worst.values()) <= 1e-3, worst
    # nothing reached the frozen models' .grad, and every module is trainable again
    for module in (wm, critic, actor):
        assert all(p.grad is None and p.requires_grad for p in module.parameters())


# ---------------------------------------------------------------------------
# the --env_backend jax collector on the device Pendulum
# ---------------------------------------------------------------------------

CT, CN = 16, 8


def _pendulum_draws(ref_env, key, n: int, actions: int, random_actions: bool):
    """Every draw of the reference's DreamerV3 collector (`rollout.py:
    198-236`) on a continuous env, in the port's layouts: a step's act key
    becomes the random phase's box sample (`random_action_sampler`) or
    `PlayerDV3.step`'s draws as `noisy_step`'s uniforms."""
    from sheeprl_tpu.envs.jax.rollout import random_action_sampler

    sampler = random_action_sampler(ref_env.action_space, [actions], True)
    draws, fresh = [], []
    k = key
    for _ in range(CT):
        k, k_act, k_step = jax.random.split(k, 3)
        if random_actions:
            draws.append(np.asarray(sampler(k_act, n)))
        else:
            draws.append(_step_draws(k_act, n, actions, True)["uniform"].numpy())
        fresh.append(_fresh(ref_env, k_step, n))
    return np.stack(draws), _stack(fresh)


@pytest.mark.parametrize("phase", ["policy", "random"])
def test_pendulum_collector_matches_the_reference_teacher_forced(phase):
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerState as RefPlayerState
    from sheeprl_tpu.algos.dreamer_v3.utils import make_device_preprocess as ref_preprocess
    from sheeprl_tpu.envs.jax import DreamerCollectorCarry as RefCarry
    from sheeprl_tpu.envs.jax import make_dreamer_collector as ref_collector
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerState
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import make_device_preprocess
    from sheeprl_tpu_torch.envs.device.rollout import make_dreamer_collector
    from sheeprl_tpu_torch.interop import collector_carry_from_jax, env_state_from_jax

    random_actions = phase == "random"
    rvenv, pvenv = _venvs("Pendulum-v1", CN, max_episode_steps=7)  # episodes end inside the chunk
    jplayer, player, actions = _players("vector")
    state, obs = jax.jit(rvenv.reset)(jax.random.PRNGKey(5))
    ref_carry = RefCarry(vec=state, obs=obs, prev_reward=jnp.zeros((CN, 1)), prev_done=jnp.zeros((CN, 1)),
                         is_first=jnp.ones((CN, 1)))
    carry = collector_carry_from_jax(pvenv.env, jax_flat(ref_carry))
    rng = np.random.default_rng(6)  # a player state mid-episode
    jstate = RefPlayerState(**{k: jnp.asarray(v) for k, v in {
        "actions": rng.uniform(-1, 1, (CN, actions)).astype(np.float32),
        "recurrent_state": rng.normal(size=(CN, TINY_DV3["recurrent_state_size"])).astype(np.float32) * 0.5,
        "stochastic_state": np.eye(D, dtype=np.float32)[rng.integers(0, D, (CN, S))].reshape(CN, -1)}.items()})
    pstate = PlayerState(**{k: _t(v) for k, v in jax_flat(jstate).items()})
    key, expl = jax.random.PRNGKey(11), 0.3
    collect = jax.jit(ref_collector(rvenv, CT, (actions,), True, ref_preprocess([]), random_actions=random_actions))
    r_pstate, r_carry, r_traj, r_ep = collect(jplayer, jstate, ref_carry, key, jnp.float32(expl))
    draws, fresh = _pendulum_draws(rvenv.env, key, CN, actions, random_actions)
    traj, ep = make_dreamer_collector(pvenv, CT, (actions,), True, make_device_preprocess([]),
                                      random_actions=random_actions)(
        player, pstate, carry, env_state_from_jax(pvenv.env, fresh), _t(draws), torch.tensor(expl))
    assert set(traj) == set(r_traj)
    for k in ("dones", "is_first"):
        np.testing.assert_array_equal(traj[k].numpy(), np.asarray(r_traj[k]), err_msg=k)
    for k in ("state", "actions", "rewards"):
        _close(traj[k], r_traj[k], f"traj {k}", rtol=1e-4, atol=1e-4)
    for k, v in jax_flat(r_carry).items():
        node = carry
        for part in k.split("."):
            node = node[part] if isinstance(node, dict) else getattr(node, part)
        if node.dtype in (torch.int32, torch.int64, torch.bool):
            np.testing.assert_array_equal(node.numpy(), np.asarray(v), err_msg=k)
        else:
            _close(node, v, f"carry {k}", rtol=1e-4, atol=1e-4)
    for k, v in jax_flat(r_pstate).items():
        _close(getattr(pstate, k), v, f"player state {k}", rtol=1e-4, atol=1e-4)
    assert float(ep["episodes"]) == float(r_ep["episodes"]) > 0
    for k in ("return_sum", "length_sum"):
        _close(ep[k], r_ep[k], f"ep {k}", rtol=1e-4, atol=1e-3)
    if random_actions:  # the box's own samples, in [-2, 2]
        assert traj["actions"].abs().max() > 1.0
    else:
        assert traj["actions"].abs().max() <= 1.0 and traj["actions"].std() > 0


# ---------------------------------------------------------------------------
# a reference checkpoint of a continuous DreamerV3
# ---------------------------------------------------------------------------

REF_TINY = [
    "--dry_run", "--num_devices=1", "--num_envs=1", "--sync_env", "--per_rank_batch_size=1",
    "--per_rank_sequence_length=1", "--buffer_size=4", "--learning_starts=0", "--gradient_steps=1",
    "--horizon=4", "--dense_units=8", "--cnn_channels_multiplier=2", "--recurrent_state_size=8",
    "--hidden_size=8", "--stochastic_size=4", "--discrete_size=4", "--mlp_layers=1", "--train_every=1",
    "--checkpoint_every=1",
]


@pytest.mark.timeout(600)
def test_reference_continuous_checkpoint_arrives_bit_for_bit(tmp_path):
    """The reference's `main` on continuous_dummy pixels writes a
    checkpoint; `interop.dreamer_v3_checkpoint_from_jax` carries it into
    the port (the actor's one 2A head included), every parameter and Adam
    moment bit for bit, and the port's `main` resumes from it."""
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import main as ref_main
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3TrainState, make_optimizers, restore_state
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop import dreamer_v3_checkpoint_from_jax, flatten_params
    from sheeprl_tpu_torch.nn.layers import Linear
    from sheeprl_tpu_torch.ops.moments import Moments
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint_args
    from sheeprl_tpu_torch.utils.parser import DataclassArgumentParser

    ref_main(REF_TINY + ["--env_id=continuous_dummy", f"--root_dir={tmp_path}", "--run_name=ref", "--cnn_keys",
                         "rgb"])
    path = str(tmp_path / "ref" / "checkpoints" / "ckpt_1")
    raw = ref_load(path)
    (args,) = DataclassArgumentParser(DreamerV3Args).parse_dict(load_checkpoint_args(path))

    def fresh(seed):
        wm, actor, critic, target = build_models(torch.Generator().manual_seed(seed), [A_DUMMY], True, args,
                                                 {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}, ["rgb"], [])
        return DV3TrainState(wm, actor, critic, target, *make_optimizers(args, wm, actor, critic),
                             Moments(args.moments_decay, args.moment_max))

    ckpt = dreamer_v3_checkpoint_from_jax(raw, fresh(1))
    state = fresh(5)
    restore_state(state, ckpt)
    assert tuple(state.actor.heads[0].weight.shape) == (2 * A_DUMMY, args.dense_units)
    for key, opt in (("world_model", state.world_opt), ("actor", state.actor_opt), ("critic", state.critic_opt),
                     ("target_critic", None)):
        module = getattr(state, key)
        linear = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, Linear)}
        ref = flatten_params(raw[key])
        params = dict(module.named_parameters())
        assert set(ref) == set(params), key
        for name, p in params.items():
            want = ref[name].T if name in linear else ref[name]
            np.testing.assert_array_equal(p.detach().numpy(), want, err_msg=f"{key}.{name}")
        if opt is None:
            continue
        adam = raw[key.replace("_model", "") + "_optimizer"][1][0]
        mu = flatten_params(adam["mu"])
        for name, p in params.items():
            want = mu[name].T if name in linear else mu[name]
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].numpy(), want, err_msg=f"{key} mu {name}")
    assert float(state.moments.low) == float(raw["moments"]["low"])


# ---------------------------------------------------------------------------
# the port's runs on the CPU
# ---------------------------------------------------------------------------

PORT_TINY = ["--device", "cpu", "--cnn_channels_multiplier", "2", "--dense_units", "16", "--hidden_size", "16",
             "--recurrent_state_size", "16", "--stochastic_size", "4", "--discrete_size", "4",
             "--per_rank_batch_size", "2", "--per_rank_sequence_length", "4", "--horizon", "3", "--buffer_size",
             "64", "--learning_starts", "16", "--train_every", "2", "--bins", "15", "--expl_amount", "0.3"]
RUNS = {
    "continuous_dummy host": ["--env_id", "continuous_dummy", "--cnn_keys", "rgb", "--num_envs", "2",
                              "--total_steps", "24", "--checkpoint_every", "8"],
    "Pendulum-v1 host": ["--env_id", "Pendulum-v1", "--mlp_keys", "state", "--num_envs", "1", "--total_steps", "24"],
    "Pendulum-v1 jax": ["--env_id", "Pendulum-v1", "--mlp_keys", "state", "--env_backend", "jax", "--num_envs",
                        "4", "--train_every", "8", "--total_steps", "48"],
}


def _records(path) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("run", list(RUNS))
def test_cpu_training_runs_with_continuous_actions(tmp_path, run):
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    dreamer_v3.main([*PORT_TINY, *RUNS[run], "--root_dir", str(tmp_path), "--run_name", "r"])
    recs = _records(tmp_path / "r" / "metrics.jsonl")
    steps, done = [r for r in recs if "gradient_steps" in r and r.get("event") != "done"], recs[-1]
    assert done["event"] == "done" and done["gradient_steps"] >= 5 and done["player_steps"] > 0
    assert all(np.isfinite(r[k]) for r in steps for k in r if k.startswith(("Loss/", "Grads/")))
    assert all(done[f"Params/{m}_delta"] > 0 for m in ("world_model", "actor", "critic"))
    assert len(done["test_returns"]) == 1 and np.isfinite(done["test_returns"][0])
    state = torch.load(done["checkpoints"][-1]["path"] + "/state.pt", weights_only=False)
    assert tuple(state["actor"]["heads.0.weight"].shape) == (2 * (A_DUMMY if "dummy" in run else 1), 16)


def _serve(argv, run_dir):
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


def test_serve_writes_its_address_whole(tmp_path, monkeypatch):
    """The address file appears by a rename of a whole file, so a client
    that polls for it never reads it empty (a card test once read '')."""
    import sheeprl_tpu_torch.serve.serve as serve_mod
    from sheeprl_tpu_torch.cli import run

    renamed = []
    real = os.replace

    def spy(src, dst):
        with open(src) as fh:
            renamed.append((os.path.basename(dst), fh.read()))
        real(src, dst)

    monkeypatch.setattr(serve_mod.os, "replace", spy)
    run(["serve", "--device", "cpu", "--model_argv", "--env_id continuous_dummy --cnn_keys rgb "
         "--cnn_channels_multiplier 2 --dense_units 16 --hidden_size 16 --recurrent_state_size 16", "--root_dir",
         str(tmp_path), "--run_name", "s", "--serve_requests", "0", "--dry_run"])
    # the ladder's memo (serve_ladder.json) is renamed into place too
    address = [text for name, text in renamed if name == "serve_address"]
    assert len(address) == 1 and address[0].startswith("unix:")
    assert os.listdir(tmp_path / "s").count("serve_address.tmp") == 0


@pytest.mark.timeout(300)
def test_eval_only_and_serve_of_a_continuous_checkpoint(tmp_path):
    """`--eval_only` over a continuous run's checkpoint plays its test
    episodes; `serve --device cpu --ckpt` answers float action rows, each
    equal to a direct `PlayerDV3.step` with the server's noise (the
    best-of-100 uniforms drawn once, from the seed); and the greedy test
    episode plays best-of-100 with fresh draws."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import BEST_OF
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import test as play
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.policies import build_policy
    from sheeprl_tpu_torch.utils.logger import create_logger

    dreamer_v3.main([*PORT_TINY, *RUNS["continuous_dummy host"], "--root_dir", str(tmp_path), "--run_name", "r"])
    ckpt = str(tmp_path / "r" / "checkpoints" / "ckpt_8")
    dreamer_v3.main(["--eval_only", "--checkpoint_path", ckpt, "--device", "cpu", "--test_episodes", "2",
                     "--root_dir", str(tmp_path), "--run_name", "e"])
    ev = _records(tmp_path / "e" / "metrics.jsonl")[-1]
    # the dummy's episode is 5 env steps; DreamerV3 repeats each action 4
    # times by default, so a test episode is 2 player steps
    assert ev["gradient_steps"] == 0 and len(ev["test_returns"]) == 2 and ev["test_player_steps"] == [2, 2]

    rng = np.random.default_rng(0)
    obs = [rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8) for _ in range(4)]
    address, thread, errors = _serve(["--device", "cpu", "--ckpt", ckpt, "--root_dir", str(tmp_path), "--run_name",
                                      "s", "--serve_requests", "4", "--deadline_ms", "0"], str(tmp_path / "s"))
    with ServeClient(address) as client:
        answers = [client.request({"rgb": o}, session="a")[0]["actions"] for o in obs]
    thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    policy, player, _ = build_policy(ServeArgs(device="cpu", ckpt=ckpt), torch.device("cpu"))
    assert tuple(policy.uniforms.shape) == (BEST_OF, A_DUMMY)
    state = {k: v[None] for k, v in policy.init_row(0, player).items()}
    for o, got in zip(obs, answers):
        with torch.inference_mode():
            state, acts = policy.step(player, state, {"rgb": torch.from_numpy(o)})
        assert got.dtype == np.float32 and got.shape == (1, A_DUMMY) and np.abs(got).max() <= 1.0
        np.testing.assert_array_equal(got, acts.numpy())
    assert len({tuple(a.ravel()) for a in answers}) > 1

    # the greedy test episode: a fresh [BEST_OF, 1, A] draw each step
    args = dreamer_v3.parse_run_args(dreamer_v3.DreamerV3Args, ["--checkpoint_path", ckpt, "--device", "cpu",
                                                                "--root_dir", str(tmp_path), "--run_name", "g"])
    logger, _ = create_logger(args, "dreamer_v3")
    calls = []
    original = player.actor.forward

    def spy(state, is_training=True, gumbels=None, uniforms=None):
        calls.append((is_training, uniforms.clone()))
        return original(state, is_training, gumbels, uniforms)

    player.actor.forward = spy
    ret, steps = play(player, logger, args, ["rgb"], sample_actions=False)
    assert steps == 2 and np.isfinite(ret) and len(calls) == steps
    assert all(not training and tuple(u.shape) == (BEST_OF, 1, A_DUMMY) for training, u in calls)
    assert not torch.equal(calls[0][1], calls[1][1])


def test_jax_backend_collector_runs_the_continuous_player_as_one_plan_entry(tmp_path):
    """`--env_backend jax` on Pendulum-v1: the player's chunks and the
    random warm-up's are the plan's two collector entries, as on
    pixeltoy; the ring holds float actions."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3

    dreamer_v3.main([*PORT_TINY, *RUNS["Pendulum-v1 jax"], "--root_dir", str(tmp_path), "--run_name", "r"])
    done = _records(tmp_path / "r" / "metrics.jsonl")[-1]
    assert done["anakin_chunk"] == 2 and done["env_steps"] == 48 and done["player_steps"] == 8
    assert set(done["compile_stats"]["entries"]) == {"train_step", "anakin_rollout", "anakin_rollout_random"}
    assert done["test_player_steps"] == [200 // 4]  # Pendulum's 200 steps, each action repeated 4 times


# ---------------------------------------------------------------------------
# the discrete path, unchanged
# ---------------------------------------------------------------------------


def test_discrete_draw_layout_and_step_are_unchanged():
    """A discrete actor keeps one head per action space and no continuous
    state; `noise_width` is S*D + sum(A) + 2 heads; `draw_noise` draws the
    posterior's, the priors' and each head's Gumbels from the generator in
    that order; a greedy step takes the mode, no uniforms."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import Actor, PlayerDV3
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import draw_noise
    from sheeprl_tpu_torch.ops.distributions import OneHotCategorical, gumbel_noise
    from tests.test_torch_interop import tiny_players

    actor = Actor(LATENT, [3, 2], False, dense_units=16, generator=torch.Generator().manual_seed(0))
    assert actor.distribution == "discrete" and [h.out_features for h in actor.heads] == [3, 2]
    assert all(isinstance(d, OneHotCategorical) for d in actor.dists(torch.zeros(2, LATENT)))
    args = DreamerV3Args(**TINY_DV3, horizon=H)
    noise = draw_noise(args, T, B, [3, 2], torch.Generator().manual_seed(4), "cpu")
    g = torch.Generator().manual_seed(4)
    want = {"post": gumbel_noise((T, B, S, D), g), "img_prior": gumbel_noise((H, T * B, S, D), g),
            "img_actions": [gumbel_noise((H + 1, T * B, a), g) for a in (3, 2)]}
    assert set(noise) == set(want) and isinstance(noise["img_actions"], list)
    for k in ("post", "img_prior"):
        assert torch.equal(noise[k], want[k])
    assert all(torch.equal(a, b) for a, b in zip(noise["img_actions"], want["img_actions"]))
    _, tplayer = tiny_players()
    player = PlayerDV3(tplayer.encoder, tplayer.rssm, tplayer.actor, actions_dim=(3,), stochastic_size=S,
                       discrete_size=D, recurrent_state_size=tplayer.recurrent_state_size)
    assert player.noise_width() == S * D + 3 + 2
    obs = {"rgb": torch.rand(2, 64, 64, 3), "state": torch.randn(2, 5)}
    gumbel = gumbel_noise((2, S, D), torch.Generator().manual_seed(1))
    with torch.inference_mode():
        _, acts = player.step(player.init_states(2), obs, gumbel=gumbel)
        latent = player._posterior(player.init_states(2), obs, gumbel)[2]
        mode = torch.cat([d.mode for d in player.actor.dists(latent)], -1)
    assert torch.equal(acts, mode)
