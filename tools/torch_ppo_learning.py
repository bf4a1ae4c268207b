#!/usr/bin/env python3
"""The reference's PPO learning test (tests/test_algos/test_learning.py:22-75)
on the port, or on the reference itself: for each seed, PPO on CartPole-v1
with its recipe (4 envs, 65,536 steps, rollout 128, batch 128, 6 epochs,
ent_coef 0.01, annealed lr, normalized advantages, max_grad_norm 0.5), then
10 greedy episodes at seeds 1000-1009 from the final checkpoint. Prints one
JSON line a seed: the mean return (the reference's bar is 400), the returns,
and the host wall of the training and the evaluation.

    python tools/torch_ppo_learning.py --device cpu --seeds 5 6 7 [--out DIR] [--eager] [--adam plain]
    python tools/torch_ppo_learning.py --package reference --seeds 5 6 7
    python tools/torch_ppo_learning.py --env_backend jax [--package reference] --seeds 5 6 7

The port runs `sheeprl_tpu_torch ppo` and `ppo --eval_only` on its own
CartPole; the reference runs `sheeprl_tpu`'s `ppo` on the CPU with
gymnasium's CartPole and evaluates as its test does (JAX and gymnasium
needed). On the card the port's steps run as CUDA graphs; `--eager` calls
each step directly instead (every CompilePlan in direct mode), the same
arithmetic without the graphs. `--adam plain` gives PPO PyTorch's default
Adam (not capturable: step counts on the host, the update's float lr), the
port's optimizer before its steps became CUDA graphs and before it took
optax's arithmetic (`ops/optim.py:Adam`); a capture refuses it, so the
steps then run eagerly. That is the arithmetic of the port's PPO before
the graphs, on the CPU and on the card.

`--env_backend jax` trains both packages on their device envs (the port's
batched CartPole on the run's device, a rollout one graph replay; the
reference's pure-JAX CartPole in one `lax.scan` on the CPU); the
evaluation stays on the host CartPole (the port's, or gymnasium's) at
seeds 1000-1009.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = ["--env_id", "CartPole-v1", "--num_envs", "4", "--total_steps", "65536", "--rollout_steps", "128",
          "--per_rank_batch_size", "128", "--update_epochs", "6", "--ent_coef", "0.01", "--anneal_lr",
          "--normalize_advantages", "--max_grad_norm", "0.5", "--checkpoint_every", "1000000"]
FINAL_UPDATE = 65536 // (128 * 4)
EVAL_SEED, EVAL_EPISODES = 1000, 10


def eager_plans() -> None:
    """Every later CompilePlan of this process calls its steps directly."""
    from sheeprl_tpu_torch.compile import plan as plan_mod

    original = plan_mod.CompilePlan.__dict__["from_args"].__func__

    def from_args(args, telem=None):
        plan = original(plan_mod.CompilePlan, args, telem)
        plan.mode = "direct"
        return plan

    plan_mod.CompilePlan.from_args = staticmethod(from_args)


def plain_adams() -> None:
    """Every later PPO run of this process builds PyTorch's default Adam,
    its steps called directly."""
    import torch

    from sheeprl_tpu_torch.algos.ppo import ppo

    ppo.adam = lambda params, lr, eps: torch.optim.Adam(params, lr=lr, eps=eps)
    eager_plans()


def port_returns(seed: int, device: str, out: str, env_backend: str = "host") -> list[float]:
    from sheeprl_tpu_torch.cli import run

    run(["ppo", *RECIPE, "--seed", str(seed), "--device", device, "--env_backend", env_backend, "--root_dir", out,
         "--run_name", f"learn_{seed}"])
    ckpt = os.path.join(out, f"learn_{seed}", "checkpoints", f"ckpt_{FINAL_UPDATE}")
    run(["ppo", "--eval_only", "--checkpoint_path", ckpt, "--test_episodes", str(EVAL_EPISODES), "--seed",
         str(EVAL_SEED), "--device", device, "--root_dir", out, "--run_name", f"eval_{seed}"])
    with open(os.path.join(out, f"eval_{seed}", "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh][-1]["test_returns"]


def reference_returns(seed: int, out: str, env_backend: str = "host") -> list[float]:
    """The reference's test body (test_learning.py:26-73) at `seed`, its
    envs on the host or (`jax`) its pure-JAX CartPole."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import gymnasium as gym
    import jax.numpy as jnp
    import numpy as np

    import sheeprl_tpu.algos  # noqa: F401 -- fires the registrations
    from sheeprl_tpu.algos.ppo.agent import PPOAgent, one_hot_to_env_actions
    from sheeprl_tpu.algos.ppo.args import PPOArgs
    from sheeprl_tpu.algos.ppo.ppo import make_optimizer
    from sheeprl_tpu.utils.checkpoint import latest_checkpoint, load_checkpoint
    from sheeprl_tpu.utils.registry import tasks

    tasks["ppo"]([*RECIPE, "--seed", str(seed), "--num_devices", "1", "--sync_env", "--env_backend", env_backend,
                  "--root_dir", out, "--run_name", f"ref_{seed}"])
    ckpt = latest_checkpoint(os.path.join(out, f"ref_{seed}", "checkpoints"))
    env = gym.make("CartPole-v1")
    template = PPOAgent.init(jax.random.PRNGKey(0), [2], {"state": env.observation_space}, [], ["state"],
                             cnn_features_dim=512, mlp_features_dim=64, screen_size=64, mlp_layers=2,
                             dense_units=64, dense_act="tanh", layer_norm=False, is_continuous=False)
    opt = make_optimizer(PPOArgs(max_grad_norm=0.5)).init(template)
    agent = load_checkpoint(ckpt, {"agent": template, "optimizer": opt, "update_step": 0})["agent"]
    greedy = jax.jit(agent.get_greedy_actions)
    returns = []
    for episode in range(EVAL_EPISODES):
        obs, _ = env.reset(seed=EVAL_SEED + episode)
        done, ret = False, 0.0
        while not done:
            actions = greedy({"state": jnp.asarray(obs, jnp.float32)[None]})
            act = one_hot_to_env_actions(np.asarray(actions[0]), agent.actions_dim, agent.is_continuous)
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
    parser.add_argument("--out", default=os.path.join(HERE, "build", "ppo_learning"))
    parser.add_argument("--eager", action="store_true", help="the port's steps called directly, not graphed")
    parser.add_argument("--adam", choices=("port", "plain"), default="port",
                        help="PPO's Adam: the port's (optax's arithmetic), or PyTorch's default (eager)")
    parser.add_argument("--env_backend", choices=("host", "jax"), default="host",
                        help="the training envs: host, or the device envs (both packages)")
    opts = parser.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np

    if opts.adam == "plain":
        plain_adams()
    elif opts.eager:
        eager_plans()
    for seed in opts.seeds:
        t0 = time.perf_counter()
        if opts.package == "port":
            returns = port_returns(seed, opts.device, opts.out, opts.env_backend)
        else:
            returns = reference_returns(seed, opts.out, opts.env_backend)
        print(json.dumps({"package": opts.package, "seed": seed, "eager": opts.eager or opts.adam == "plain",
                          "adam": opts.adam, "env_backend": opts.env_backend,
                          "device": opts.device if opts.package == "port" else "cpu",
                          "mean_return": float(np.mean(returns)), "returns": returns,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
