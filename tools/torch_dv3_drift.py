#!/usr/bin/env python3
"""How far the port's DreamerV3 gradient steps follow the reference's at the
learning receipt's widths (tests/test_algos/test_learning.py:215-245:
CartPole-v1's 4-vector, 2 actions, dense, hidden and recurrent 256, 16 x 16
latents, 2 MLP layers, horizon 15, B 16 x T 32, 255 bins), each package
carrying its own state over `--steps` consecutive steps: both start from
the reference's initial parameters (`interop`), and each step takes the
same [T, B] window batch (rows of the port's CartPole under random
actions, in the replay ring's layout: episode ends and starts inside the
windows) and the reference's own draws for its key, tau 1 at the first
step and 0.02 after it. Prints one JSON line a step: the largest
parameter gap of each module over its learning rate, the moments' gap,
and the largest relative gap of the 13 metrics. On the CPU (JAX and the
reference needed):

    python tools/torch_dv3_drift.py --steps 64

An Adam step moves a parameter by about lr sign(g), so a gap of up to 2 lr
a step is rounding (a near-zero gradient taking either sign); a gap that
grows faster feeds on itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = dict(dense_units=256, hidden_size=256, recurrent_state_size=256, stochastic_size=16, discrete_size=16,
              mlp_layers=2, horizon=15, per_rank_batch_size=16, per_rank_sequence_length=32)
ROWS = 4096  # rows of random-action CartPole the windows are drawn from


def cartpole_rows(seed: int):
    """ROWS replay rows of the port's CartPole under uniform random actions,
    in DreamerV3's ring layout (an episode's last row holds its final obs,
    done 1 and a zero action; the next row is the reset obs with is_first)."""
    import numpy as np

    from sheeprl_tpu_torch.envs.cartpole import CartPole

    rng = np.random.default_rng(seed)
    env = CartPole(0)
    obs, _ = env.reset(seed=seed)
    rows = {k: [] for k in ("state", "actions", "rewards", "dones", "is_first")}
    reward, first = 0.0, 1.0
    while len(rows["state"]) < ROWS:
        a = int(rng.integers(0, 2))
        for k, v in (("state", obs), ("actions", np.eye(2)[a]), ("rewards", [reward]), ("dones", [0.0]),
                     ("is_first", [first])):
            rows[k].append(np.asarray(v, np.float32))
        obs, reward, term, trunc, _ = env.step(a)
        first = 0.0
        if term or trunc:
            for k, v in (("state", obs), ("actions", np.zeros(2)), ("rewards", [reward]), ("dones", [1.0]),
                         ("is_first", [0.0])):
                rows[k].append(np.asarray(v, np.float32))
            obs, _ = env.reset(seed=int(rng.integers(0, 2**31)))
            reward, first = 0.0, 1.0
    return {k: np.stack(v[:ROWS]) for k, v in rows.items()}


def jax_flat(tree) -> dict:
    """A JAX module pytree -> {dotted field path: numpy array}."""
    import jax
    import numpy as np

    def part(k) -> str:
        return next(str(getattr(k, a)) for a in ("name", "idx", "key") if hasattr(k, a))

    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(part(k) for k in path): np.asarray(leaf) for path, leaf in leaves}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=64)
    parser.add_argument("--seed", type=int, default=5)
    opts = parser.parse_args()
    sys.path.insert(0, HERE)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import gymnasium as gym
    import jax.numpy as jnp
    import numpy as np
    import torch

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

    rargs, args = RefArgs(**RECIPE), DreamerV3Args(**RECIPE)
    T, B, H = args.per_rank_sequence_length, args.per_rank_batch_size, args.horizon
    S, D, A = args.stochastic_size, args.discrete_size, 2
    models = ref_build(jax.random.PRNGKey(opts.seed), [A], False, rargs,
                       {"state": gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)}, [], ["state"])
    wopt, aopt, copt = ref_optimizers(rargs)
    ref = RefState(world_model=models[0], actor=models[1], critic=models[2], target_critic=models[3],
                   world_opt=wopt.init(models[0]), actor_opt=aopt.init(models[1]), critic_opt=copt.init(models[2]),
                   moments=ops.Moments.init(rargs.moments_decay, rargs.moment_max, rargs.moments_percentile_low,
                                            rargs.moments_percentile_high))
    port_models = build_models(torch.Generator().manual_seed(0), [A], False, args,
                               {"state": spaces.Box(-np.inf, np.inf, (4,))}, [], ["state"])
    for ref_module, module in zip(models, port_models):
        load_jax_params(module, jax_flat(ref_module))
    port = DV3TrainState(*port_models, *make_optimizers(args, *port_models[:3]),
                         Moments(args.moments_decay, args.moment_max, args.moments_percentile_low,
                                 args.moments_percentile_high))
    ref_step = ref_train_step(rargs, wopt, aopt, copt, [], ["state"], [A], False)
    step = make_train_step(args, [], ["state"], [A], False)
    rows = cartpole_rows(opts.seed)
    rng = np.random.default_rng(opts.seed)
    lrs = {"world_model": args.world_lr, "actor": args.actor_lr, "critic": args.critic_lr,
           "target_critic": args.critic_lr}

    def noise(key) -> dict:
        """The reference step's draws from its key tree
        (`tests/test_torch_dv3_train.py:_noise`)."""
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

    for k in range(1, opts.steps + 1):
        t0 = time.perf_counter()
        starts = rng.integers(0, ROWS - T, B)
        idx = starts[None, :] + np.arange(T)[:, None]  # [T, B]
        batch = {n: v[idx] for n, v in rows.items()}
        tau = 1.0 if k == 1 else args.critic_tau
        key = jax.random.PRNGKey(10_000 + k)
        ref, ref_metrics = ref_step(ref, {n: jnp.asarray(v) for n, v in batch.items()}, key, jnp.float32(tau))
        metrics = step(port, {n: torch.from_numpy(v) for n, v in batch.items()}, tau, noise(key))
        gaps = {}
        for name in lrs:
            module = getattr(port, name)
            want, got = state_dict_from_jax(module, jax_flat(getattr(ref, name))), module.state_dict()
            gaps[name] = max(float((got[p] - want[p]).abs().max()) for p in got) / lrs[name]
        moments = [float(port.moments.low) - float(ref.moments.low), float(port.moments.high) - float(ref.moments.high)]
        metric_gap = max(abs(metrics[n] - float(v)) / max(abs(float(v)), 1e-6) for n, v in ref_metrics.items())
        print(json.dumps({"step": k, "gap_over_lr": gaps, "moments_gap": max(abs(m) for m in moments),
                          "metric_rel_gap": metric_gap, "policy_loss": [metrics["Loss/policy_loss"],
                                                                        float(ref_metrics["Loss/policy_loss"])],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
