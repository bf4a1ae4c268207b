"""Eight consecutive DreamerV3 gradient steps in both packages, each package
carrying its own state forward (no re-sync between the steps), at tiny
widths on the learning receipt's observations (CartPole-v1's 4-vector, 2
discrete actions, `tests/test_algos/test_learning.py:202-295`): each step
its own batch (an episode boundary inside it, as the ring's windows have)
and the reference's own draws for that step's key, tau 1 at the first step
and the default 0.02 after it, as the main gives them.

The one-step test (`tests/test_torch_dv3_train.py`) bounds a single step;
this one bounds the drift that a one-step test cannot see. After step k
every parameter of every module (and the moments' percentiles) must be
within 2 k lr + 1e-5 of the reference's, lr the module's own (the target
critic takes the critic's): each Adam step moves a parameter by about lr
sign(g), so the two packages can part by at most 2 lr a step where a
gradient near zero rounds to either sign, and more only if the drift feeds
on itself. The gaps are printed after each step (`pytest -s`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_interop import jax_flat

TINY = dict(
    dense_units=16, recurrent_state_size=16, hidden_size=16, stochastic_size=4, discrete_size=4, mlp_layers=2,
    per_rank_batch_size=4, per_rank_sequence_length=8, horizon=5, bins=15,
)
T, B, S, D, H, A, OBS = 8, 4, 4, 4, 5, 2, 4
STEPS = 8
MODULES = ("world_model", "actor", "critic", "target_critic")


def _batch(step: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(100 + step)
    dones, is_first = np.zeros((T, B, 1), np.float32), np.zeros((T, B, 1), np.float32)
    end = int(rng.integers(0, T - 1))
    dones[end, step % B] = 1.0
    is_first[end + 1, step % B] = 1.0
    return {
        "state": (rng.normal(size=(T, B, OBS)) * [0.5, 0.5, 0.05, 0.5]).astype(np.float32),
        "actions": np.eye(A, dtype=np.float32)[rng.integers(0, A, (T, B))],
        "rewards": np.ones((T, B, 1), np.float32),
        "dones": dones,
        "is_first": is_first,
    }


def _noise(key) -> dict:
    """The reference step's Gumbel draws, rebuilt from its key tree as
    `tests/test_torch_dv3_train.py:_noise` rebuilds them."""
    k_wm, k_img = jax.random.split(key)
    post = [jax.random.gumbel(jax.random.split(k)[1], (B, S, D)) for k in jax.random.split(k_wm, T)]
    img_keys = jax.random.split(k_img, H + 1)
    prior, acts = [], []
    for h in range(H):
        k_act, k_trans = jax.random.split(img_keys[h])
        acts.append(jax.random.gumbel(jax.random.split(k_act)[1], (T * B, A)))
        prior.append(jax.random.gumbel(k_trans, (T * B, S, D)))
    acts.append(jax.random.gumbel(jax.random.split(img_keys[H])[1], (T * B, A)))
    t = lambda xs: torch.from_numpy(np.array(jnp.stack(xs)))  # noqa: E731
    return {"post": t(post), "img_prior": t(prior), "img_actions": [t(acts)]}


@pytest.mark.timeout(600)
def test_eight_steps_stay_within_the_adam_bound():
    import gymnasium as gym

    from sheeprl_tpu import ops
    from sheeprl_tpu.algos.dreamer_v3.agent import build_models as ref_build
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args as RefArgs
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import DV3TrainState as RefState
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_optimizers as ref_optimizers
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as ref_train_step
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import DV3TrainState, make_optimizers, make_train_step
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.interop import load_jax_params, state_dict_from_jax
    from sheeprl_tpu_torch.ops.moments import Moments

    rargs, args = RefArgs(**TINY), DreamerV3Args(**TINY)
    models = ref_build(jax.random.PRNGKey(0), [A], False, rargs,
                       {"state": gym.spaces.Box(-np.inf, np.inf, (OBS,), np.float32)}, [], ["state"])
    wopt, aopt, copt = ref_optimizers(rargs)
    ref = RefState(world_model=models[0], actor=models[1], critic=models[2], target_critic=models[3],
                   world_opt=wopt.init(models[0]), actor_opt=aopt.init(models[1]), critic_opt=copt.init(models[2]),
                   moments=ops.Moments.init(rargs.moments_decay, rargs.moment_max, rargs.moments_percentile_low,
                                            rargs.moments_percentile_high))
    port_models = build_models(torch.Generator().manual_seed(1), [A], False, args,
                               {"state": spaces.Box(-np.inf, np.inf, (OBS,))}, [], ["state"])
    for ref_module, module in zip(models, port_models):
        load_jax_params(module, jax_flat(ref_module))
    port = DV3TrainState(*port_models, *make_optimizers(args, *port_models[:3]),
                         Moments(args.moments_decay, args.moment_max, args.moments_percentile_low,
                                 args.moments_percentile_high))
    ref_step = ref_train_step(rargs, wopt, aopt, copt, [], ["state"], [A], False)
    step = make_train_step(args, [], ["state"], [A], False)
    lrs = {"world_model": args.world_lr, "actor": args.actor_lr, "critic": args.critic_lr,
           "target_critic": args.critic_lr}
    for k in range(1, STEPS + 1):
        tau = 1.0 if k == 1 else args.critic_tau
        batch, key = _batch(k), jax.random.PRNGKey(1000 + k)
        ref, ref_metrics = ref_step(ref, {n: jnp.asarray(v) for n, v in batch.items()}, key, jnp.float32(tau))
        metrics = step(port, {n: torch.from_numpy(v) for n, v in batch.items()}, tau, _noise(key))
        gap = {}
        for name in MODULES:
            module = getattr(port, name)
            want, got = state_dict_from_jax(module, jax_flat(getattr(ref, name))), module.state_dict()
            gap[name] = max(float((got[p] - want[p]).abs().max()) for p in got)
        moments = np.array([float(port.moments.low), float(port.moments.high)])
        gap["moments"] = float(np.abs(moments - [float(ref.moments.low), float(ref.moments.high)]).max())
        metric_gap = max(abs(metrics[n] - float(v)) / max(abs(float(v)), 1.0) for n, v in ref_metrics.items())
        print(f"[dv3 multistep] step {k}: largest parameter gap "
              + ", ".join(f"{n} {g:.3e}" for n, g in gap.items()) + f"; largest relative metric gap {metric_gap:.3e}")
        for name in MODULES:
            assert gap[name] <= 2 * k * lrs[name] + 1e-5, (k, name, gap[name])
        assert gap["moments"] <= 1e-3 * max(1.0, float(np.abs(moments).max())), (k, gap["moments"])
        assert metric_gap <= 1e-2, (k, metric_gap)
