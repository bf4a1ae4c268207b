#!/usr/bin/env python3
"""The reference's SAC and DroQ learning tests (tests/test_algos/test_learning.py:
129-160 and 165-197) on the port, or on the reference itself: for each seed,
`sac` (15,000 steps) or `droq` (10,000 steps, `gradient_steps` 2) on
Pendulum-v1 with one env, `learning_starts` 1,000, batch 128 and width 256,
then 10 greedy episodes at seeds 1000-1009 from the final checkpoint. Prints
one JSON line a seed: the mean return (the reference's bar is -300), the
returns, and the host wall of the run.

    python tools/torch_sac_learning.py --algo sac --device cpu --seeds 5 6 7 [--out DIR] [--eager]
    python tools/torch_sac_learning.py --algo droq --package reference --seeds 5 6 7

The port runs `sheeprl_tpu_torch <algo>` and `<algo> --eval_only` on its own
Pendulum (`envs/pendulum.py`, whose resets draw from numpy); the reference
runs `sheeprl_tpu`'s main on the CPU with gymnasium's Pendulum and evaluates
as its test does (JAX and gymnasium needed). On the card the port's steps
run as CUDA graphs; `--eager` calls each step directly instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = {
    "sac": ["--env_id", "Pendulum-v1", "--num_envs", "1", "--total_steps", "15000", "--learning_starts", "1000",
            "--per_rank_batch_size", "128", "--gradient_steps", "1", "--actor_hidden_size", "256",
            "--critic_hidden_size", "256", "--checkpoint_every", "1000000"],
    "droq": ["--env_id", "Pendulum-v1", "--num_envs", "1", "--total_steps", "10000", "--learning_starts", "1000",
             "--per_rank_batch_size", "128", "--gradient_steps", "2", "--actor_hidden_size", "256",
             "--critic_hidden_size", "256", "--checkpoint_every", "1000000"],
}
FINAL_STEP = {"sac": 15000, "droq": 10000}
EVAL_SEED, EVAL_EPISODES, BAR = 1000, 10, -300.0


def eager_plans() -> None:
    """Every later CompilePlan of this process calls its steps directly."""
    from sheeprl_tpu_torch.compile import plan as plan_mod

    original = plan_mod.CompilePlan.__dict__["from_args"].__func__

    def from_args(args, telem=None):
        plan = original(plan_mod.CompilePlan, args, telem)
        plan.mode = "direct"
        return plan

    plan_mod.CompilePlan.from_args = staticmethod(from_args)


def port_returns(algo: str, seed: int, device: str, out: str) -> tuple[list[float], dict]:
    """-> (the greedy returns, the training run's "done" record)."""
    from sheeprl_tpu_torch.cli import run

    run([algo, *RECIPES[algo], "--seed", str(seed), "--device", device, "--root_dir", out, "--run_name",
         f"learn_{seed}"])
    with open(os.path.join(out, f"learn_{seed}", "metrics.jsonl")) as fh:
        done = [json.loads(line) for line in fh][-1]
    ckpt = os.path.join(out, f"learn_{seed}", "checkpoints", f"ckpt_{FINAL_STEP[algo]}")
    run([algo, "--eval_only", "--checkpoint_path", ckpt, "--test_episodes", str(EVAL_EPISODES), "--seed",
         str(EVAL_SEED), "--device", device, "--root_dir", out, "--run_name", f"eval_{seed}"])
    with open(os.path.join(out, f"eval_{seed}", "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh][-1]["test_returns"], done


def reference_returns(algo: str, seed: int, out: str) -> list[float]:
    """The reference's test body (test_learning.py:134-160, :170-197) at
    `seed`."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import gymnasium as gym
    import jax.numpy as jnp
    import numpy as np

    import sheeprl_tpu.algos  # noqa: F401 -- fires the registrations
    from sheeprl_tpu.algos.sac.sac import make_optimizers
    from sheeprl_tpu.utils.checkpoint import latest_checkpoint, load_checkpoint
    from sheeprl_tpu.utils.registry import tasks

    if algo == "sac":
        from sheeprl_tpu.algos.sac.agent import SACAgent as Agent
        from sheeprl_tpu.algos.sac.args import SACArgs as Args
    else:
        from sheeprl_tpu.algos.droq.agent import DROQAgent as Agent
        from sheeprl_tpu.algos.droq.args import DROQArgs as Args
    tasks[algo]([*RECIPES[algo], "--seed", str(seed), "--num_devices", "1", "--sync_env", "--root_dir", out,
                 "--run_name", f"ref_{algo}_{seed}"])
    ckpt = latest_checkpoint(os.path.join(out, f"ref_{algo}_{seed}", "checkpoints"))
    env = gym.make("Pendulum-v1")
    template = Agent.init(jax.random.PRNGKey(0), int(np.prod(env.observation_space.shape)),
                          int(np.prod(env.action_space.shape)), actor_hidden_size=256, critic_hidden_size=256,
                          action_low=env.action_space.low, action_high=env.action_space.high)
    qf, actor, alpha = make_optimizers(Args())
    state = load_checkpoint(ckpt, {"agent": template, "qf_optimizer": qf.init(template.critics),
                                   "actor_optimizer": actor.init(template.actor),
                                   "alpha_optimizer": alpha.init(template.log_alpha), "global_step": 0})
    greedy = jax.jit(state["agent"].actor.get_greedy_actions)
    returns = []
    for episode in range(EVAL_EPISODES):
        obs, _ = env.reset(seed=EVAL_SEED + episode)
        done, ret = False, 0.0
        while not done:
            action = greedy(jnp.asarray(obs, jnp.float32)[None])
            obs, reward, terminated, truncated, _ = env.step(np.asarray(action[0]))
            ret += float(reward)
            done = terminated or truncated
        returns.append(ret)
    env.close()
    return returns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--algo", choices=sorted(RECIPES), default="sac")
    parser.add_argument("--package", choices=("port", "reference"), default="port")
    parser.add_argument("--device", default="cuda", help="the port's --device (the reference runs on the CPU)")
    parser.add_argument("--seeds", type=int, nargs="+", default=[5])
    parser.add_argument("--out", default=os.path.join(HERE, "build", "sac_learning"))
    parser.add_argument("--eager", action="store_true", help="the port's steps called directly, not graphed")
    opts = parser.parse_args()
    sys.path.insert(0, HERE)
    import numpy as np

    if opts.eager:
        eager_plans()
    for seed in opts.seeds:
        t0 = time.perf_counter()
        done: dict = {}
        if opts.package == "port":
            returns, done = port_returns(opts.algo, seed, opts.device, opts.out)
        else:
            returns = reference_returns(opts.algo, seed, opts.out)
        mean = float(np.mean(returns))
        print(json.dumps({"package": opts.package, "algo": opts.algo, "seed": seed, "eager": opts.eager,
                          "device": opts.device if opts.package == "port" else "cpu", "mean_return": mean,
                          "passed": mean >= BAR, "returns": returns, "seconds": time.perf_counter() - t0,
                          **{k: done[k] for k in ("wall_s", "env_steps_per_s", "learn_ms_per_step", "burst_s",
                                                  "train_calls") if k in done}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
