#!/usr/bin/env python3
"""The reference's DreamerV3 learning test (tests/test_algos/test_learning.py:
202-295) on the port, or on the reference itself: for each seed, DreamerV3
on CartPole-v1 with the test's command as it stands (6,144 env steps, one
env through the synchronous runner, training every 4 steps after 512, batch
16 x 32, widths 256, 16 x 16 latents, horizon 15, no action repeat), then
10 greedy episodes at seeds 1000-1009 from the final checkpoint. Prints one
JSON line a seed: the mean return (the reference's bar is 120,
test_learning.py:295), the returns, and the host wall of the training and
the evaluation.

    python tools/torch_dv3_learning.py --device cuda --seeds 5 6 7 [--out DIR]
    python tools/torch_dv3_learning.py --package reference --seeds 5 6 7

The port runs `sheeprl_tpu_torch dreamer_v3` with the reference's flags
verbatim, on its own CartPole, then plays the greedy player (the actor's
mode, `algos/dreamer_v3/utils.py:test`) in a fresh env a seed. The
reference runs `sheeprl_tpu`'s `dreamer_v3` on the CPU with gymnasium's
CartPole and evaluates as its test does (JAX and gymnasium needed). The two
envs draw their start states differently for the same seed, so the
episodes are the same task, not the same starts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_algos/test_learning.py:215-245, as it stands
RECIPE = ["--env_id", "CartPole-v1", "--num_devices", "1", "--num_envs", "1", "--sync_env", "--total_steps", "6144",
          "--learning_starts", "512", "--train_every", "4", "--per_rank_batch_size", "16",
          "--per_rank_sequence_length", "32", "--buffer_size", "100000", "--dense_units", "256", "--hidden_size",
          "256", "--recurrent_state_size", "256", "--stochastic_size", "16", "--discrete_size", "16", "--mlp_layers",
          "2", "--horizon", "15", "--action_repeat", "1", "--checkpoint_every", "1000000", "--mlp_keys", "state"]
FINAL_STEP = 6144
EVAL_SEED, EVAL_EPISODES, BAR = 1000, 10, 120.0


def port_returns(seed: int, device: str, out: str) -> list[float]:
    import torch

    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3, build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import test
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from sheeprl_tpu_torch.utils.env import make_dict_env
    from sheeprl_tpu_torch.utils.evaluation import parse_run_args
    from sheeprl_tpu_torch.utils.logger import create_logger

    run(["dreamer_v3", *RECIPE, "--seed", str(seed), "--device", device, "--root_dir", out,
         "--run_name", f"learn_{seed}"])
    ckpt = os.path.join(out, f"learn_{seed}", "checkpoints", f"ckpt_{FINAL_STEP}")
    args = parse_run_args(DreamerV3Args, ["--checkpoint_path", ckpt, "--device", device, "--root_dir", out,
                                          "--run_name", f"eval_{seed}"])
    logger, _ = create_logger(args, "dreamer_v3")
    space = make_dict_env(args.env_id, EVAL_SEED, 0, args)().observation_space
    dev = torch.device(device)
    wm, actor, _, _ = build_models(torch.Generator().manual_seed(0), [2], False, args, space.spaces, [], ["state"])
    state = load_checkpoint(ckpt, dev)
    wm.load_state_dict(state["world_model"])
    actor.load_state_dict(state["actor"])
    wm.to(dev)
    actor.to(dev)
    player = PlayerDV3(wm.encoder, wm.rssm, actor, actions_dim=[2], stochastic_size=args.stochastic_size,
                       discrete_size=args.discrete_size, recurrent_state_size=args.recurrent_state_size,
                       is_continuous=False, compute_dtype=args.precision)
    returns = []
    for episode in range(EVAL_EPISODES):
        args.seed = EVAL_SEED + episode
        returns.append(test(player, logger, args, [], sample_actions=False)[0])
    return returns


def reference_returns(seed: int, out: str) -> list[float]:
    """The reference's test body (test_learning.py:215-293) at `seed`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import gymnasium as gym
    import jax.numpy as jnp
    import numpy as np

    import sheeprl_tpu.algos  # noqa: F401 -- fires the registrations
    from sheeprl_tpu import ops
    from sheeprl_tpu.algos.dreamer_v3.agent import PlayerDV3, build_models
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_optimizers
    from sheeprl_tpu.algos.ppo.agent import one_hot_to_env_actions
    from sheeprl_tpu.utils.checkpoint import latest_checkpoint, load_checkpoint
    from sheeprl_tpu.utils.registry import tasks

    tasks["dreamer_v3"]([*RECIPE, "--seed", str(seed), "--root_dir", out, "--run_name", f"ref_{seed}"])
    ckpt = latest_checkpoint(os.path.join(out, f"ref_{seed}", "checkpoints"))
    env = gym.make("CartPole-v1")
    args = DreamerV3Args(env_id="CartPole-v1", seed=seed)
    args.cnn_keys, args.mlp_keys = [], ["state"]
    args.dense_units = args.hidden_size = args.recurrent_state_size = 256
    args.stochastic_size = args.discrete_size = 16
    args.mlp_layers, args.horizon, args.action_repeat = 2, 15, 1
    wm, actor, critic, tcritic = build_models(jax.random.PRNGKey(0), [2], False, args,
                                              {"state": env.observation_space}, [], ["state"])
    wopt, aopt, copt = make_optimizers(args)
    restored = load_checkpoint(ckpt, {
        "world_model": wm, "actor": actor, "critic": critic, "target_critic": tcritic,
        "world_optimizer": wopt.init(wm), "actor_optimizer": aopt.init(actor), "critic_optimizer": copt.init(critic),
        "moments": ops.Moments.init(args.moments_decay, args.moment_max),
        "expl_decay_steps": 0, "global_step": 0, "batch_size": 0,
    })
    player = PlayerDV3(encoder=restored["world_model"].encoder, rssm=restored["world_model"].rssm,
                       actor=restored["actor"], actions_dim=(2,), stochastic_size=16, discrete_size=16,
                       recurrent_state_size=256, is_continuous=False)
    step = jax.jit(lambda p, s, o, k: p.step(s, o, k, jnp.float32(0.0), is_training=False))
    returns = []
    for episode in range(EVAL_EPISODES):
        obs, _ = env.reset(seed=EVAL_SEED + episode)
        state = player.init_states(1)
        key = jax.random.PRNGKey(episode)
        done, ret = False, 0.0
        while not done:
            key, sub = jax.random.split(key)
            state, actions = step(player, state, {"state": jnp.asarray(obs, jnp.float32)[None]}, sub)
            act = one_hot_to_env_actions(np.asarray(actions), (2,), False)[0]
            obs, reward, terminated, truncated, _ = env.step(act.item())
            ret += float(reward)
            done = terminated or truncated
        returns.append(ret)
    env.close()
    return returns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", choices=("port", "reference"), default="port")
    parser.add_argument("--device", default="cuda", help="the port's --device (the reference runs on the CPU)")
    parser.add_argument("--seeds", type=int, nargs="+", default=[5])
    parser.add_argument("--out", default=os.path.join(HERE, "build", "dv3_learning"))
    opts = parser.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np

    for seed in opts.seeds:
        t0 = time.perf_counter()
        if opts.package == "port":
            returns = port_returns(seed, opts.device, opts.out)
        else:
            returns = reference_returns(seed, opts.out)
        mean = float(np.mean(returns))
        print(json.dumps({"package": opts.package, "seed": seed, "device": opts.device if opts.package == "port"
                          else "cpu", "mean_return": mean, "passes": mean >= BAR, "bar": BAR, "returns": returns,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
