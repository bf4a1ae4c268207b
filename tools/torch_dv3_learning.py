#!/usr/bin/env python3
"""The reference's Dreamer-family learning tests on the port, or on the
reference itself: for each seed, the test's command as it stands, then 10
greedy episodes at seeds 1000-1009 from the final checkpoint. Prints one
JSON line a seed: the mean return against the test's bar, the returns, and
the host wall of the training and the evaluation.

- `--algo dreamer_v3` (tests/test_algos/test_learning.py:202-295) and
  `dreamer_v2` (:298-387): CartPole-v1, 6,144 env steps, one env through
  the synchronous runner, training every 4 steps after 512, batch 16 x 32,
  widths 256, 16 x 16 latents, horizon 15, no action repeat; bar 120.
- `--algo dreamer_v1` (:485-): Pendulum-v1, 12,288 env steps, training
  every 4 after 1,024, batch 16 x 32, widths 200, a 30-wide Gaussian state,
  no continue head, exploration 0.3 decaying to 0.05; bar -1,100.

    python tools/torch_dv3_learning.py --device cuda --seeds 5 6 7 [--out DIR]
    python tools/torch_dv3_learning.py --algo dreamer_v2 --package reference --seeds 5 6 7
    python tools/torch_dv3_learning.py --plain_kernels all --seeds 5 6 7

The port runs `sheeprl_tpu_torch <algo>` with the reference's flags
verbatim, on its own CartPole or Pendulum, then plays the greedy player
(the actor's mode, or for DreamerV1's tanh-normal actor its mode through
the `test` of `algos/<algo>/utils.py`) in a fresh env a seed. The reference
runs `sheeprl_tpu`'s task on the CPU with gymnasium's env and evaluates as
its test does (JAX and gymnasium needed). The two packages' envs draw
their start states differently for the same seed, so the episodes are the
same task, not the same starts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_algos/test_learning.py:215-245 and :315-337 (the same list), as they stand
CARTPOLE = ["--env_id", "CartPole-v1", "--num_devices", "1", "--num_envs", "1", "--sync_env", "--total_steps", "6144",
            "--learning_starts", "512", "--train_every", "4", "--per_rank_batch_size", "16",
            "--per_rank_sequence_length", "32", "--buffer_size", "100000", "--dense_units", "256", "--hidden_size",
            "256", "--recurrent_state_size", "256", "--stochastic_size", "16", "--discrete_size", "16",
            "--mlp_layers", "2", "--horizon", "15", "--action_repeat", "1", "--checkpoint_every", "1000000",
            "--mlp_keys", "state"]
# tests/test_algos/test_learning.py:506-535, as it stands
PENDULUM = ["--env_id", "Pendulum-v1", "--num_devices", "1", "--num_envs", "1", "--sync_env", "--total_steps",
            "12288", "--learning_starts", "1024", "--train_every", "4", "--gradient_steps", "1",
            "--per_rank_batch_size", "16", "--per_rank_sequence_length", "32", "--buffer_size", "100000",
            "--dense_units", "200", "--hidden_size", "200", "--recurrent_state_size", "200", "--stochastic_size",
            "30", "--mlp_layers", "2", "--horizon", "15", "--action_repeat", "1", "--checkpoint_every", "4096",
            "--no_use_continues", "--expl_amount", "0.3", "--expl_decay", "--expl_min", "0.05",
            "--max_step_expl_decay", "2000", "--actor_lr", "3e-4", "--critic_lr", "3e-4", "--mlp_keys", "state"]
# algo -> (recipe, final step, env, bar)
RECIPES = {
    "dreamer_v3": (CARTPOLE, 6144, "CartPole-v1", 120.0),
    "dreamer_v2": (CARTPOLE, 6144, "CartPole-v1", 120.0),
    "dreamer_v1": (PENDULUM, 12288, "Pendulum-v1", -1100.0),
}
EVAL_SEED, EVAL_EPISODES = 1000, 10


PLAIN_KERNELS = ("rssm", "gru", "gru_player", "gru_imagination", "two_hot", "conv")


def use_plain_kernels(names) -> None:
    """Point the named kernels' calls in the port's modules at their plain
    PyTorch versions (`chip_smoke.py:train_plain_check`'s substitution):
    "rssm" kernel 5, "gru" kernels 1 and 2, "two_hot" kernel 7, "conv"
    kernels 3 and 4; "gru_player" only the GRU calls without autograd (the
    player's steps), "gru_imagination" only those with it (a gradient
    step's imagination). A run on the card then differs from one with the
    kernels in those kernels' numerics alone."""
    import torch
    import sheeprl_tpu_torch.algos.dreamer_v3.agent as agent_mod
    import sheeprl_tpu_torch.nn.blocks as blocks_mod
    import sheeprl_tpu_torch.nn.recurrent as recurrent_mod
    import sheeprl_tpu_torch.ops.distributions as dist_mod
    from sheeprl_tpu_torch.ops.kernels import cnn, deconv, gru, rssm, two_hot

    if "conv" in names:
        blocks_mod.conv_ln_silu, blocks_mod.deconv_ln_silu = cnn.conv_ln_silu_plain, deconv.deconv_ln_silu_plain
    if "gru" in names:
        recurrent_mod.layernorm_gru_cell = gru.layernorm_gru_cell_plain
    elif "gru_player" in names or "gru_imagination" in names:
        kernel, plain = gru.layernorm_gru_cell, gru.layernorm_gru_cell_plain

        def gru_call(*args):
            learning = torch.is_grad_enabled() and any(torch.is_tensor(a) and a.requires_grad for a in args)
            return plain(*args) if ("gru_imagination" if learning else "gru_player") in names else kernel(*args)

        recurrent_mod.layernorm_gru_cell = gru_call
    if "two_hot" in names:
        dist_mod.two_hot_log_prob = two_hot.two_hot_log_prob_plain
    if "rssm" in names:
        agent_mod.fused_rssm_step = rssm.fused_rssm_step_plain


def port_returns(seed: int, device: str, out: str, algo: str = "dreamer_v3") -> list[float]:
    import importlib

    import torch

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from sheeprl_tpu_torch.utils.env import make_dict_env
    from sheeprl_tpu_torch.utils.evaluation import parse_run_args
    from sheeprl_tpu_torch.utils.logger import create_logger

    recipe, final_step, _, _ = RECIPES[algo]
    agent = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.agent")
    args_mod = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.args")
    # DreamerV1 evaluates with DreamerV2's `test`, as in the reference
    test = importlib.import_module(f"sheeprl_tpu_torch.algos.{'dreamer_v3' if algo == 'dreamer_v3' else 'dreamer_v2'}"
                                   ".utils").test
    args_cls = {"dreamer_v3": "DreamerV3Args", "dreamer_v2": "DreamerV2Args", "dreamer_v1": "DreamerV1Args"}[algo]
    player_cls = {"dreamer_v3": "PlayerDV3", "dreamer_v2": "PlayerDV2", "dreamer_v1": "PlayerDV1"}[algo]

    run([algo, *recipe, "--seed", str(seed), "--device", device, "--root_dir", out, "--run_name", f"learn_{seed}"])
    ckpt = os.path.join(out, f"learn_{seed}", "checkpoints", f"ckpt_{final_step}")
    args = parse_run_args(getattr(args_mod, args_cls), ["--checkpoint_path", ckpt, "--device", device,
                                                        "--root_dir", out, "--run_name", f"eval_{seed}"])
    logger, _ = create_logger(args, algo)
    env = make_dict_env(args.env_id, EVAL_SEED, 0, args)()
    space = env.observation_space
    continuous = algo == "dreamer_v1"
    actions_dim = [int(env.action_space.shape[0])] if continuous else [int(env.action_space.n)]
    dev = torch.device(device)
    models = agent.build_models(torch.Generator().manual_seed(0), actions_dim, continuous, args, space.spaces, [],
                                ["state"])
    wm, actor = models[0], models[1]
    state = load_checkpoint(ckpt, dev)
    wm.load_state_dict(state["world_model"])
    actor.load_state_dict(state["actor"])
    wm.to(dev)
    actor.to(dev)
    player = getattr(agent, player_cls)(
        wm.encoder, wm.rssm, actor, actions_dim=actions_dim, stochastic_size=args.stochastic_size,
        discrete_size=getattr(args, "discrete_size", 0), recurrent_state_size=args.recurrent_state_size,
        is_continuous=continuous, compute_dtype=args.precision)
    returns = []
    for episode in range(EVAL_EPISODES):
        args.seed = EVAL_SEED + episode
        returns.append(test(player, logger, args, [], sample_actions=False)[0])
    return returns


def reference_returns(seed: int, out: str, algo: str = "dreamer_v3") -> list[float]:
    """The reference's test body (test_learning.py:215-293, :315-387 or
    :506-582) at `seed`."""
    import importlib

    import jax

    jax.config.update("jax_platforms", "cpu")
    import gymnasium as gym
    import jax.numpy as jnp
    import numpy as np

    import sheeprl_tpu.algos  # noqa: F401 -- fires the registrations
    from sheeprl_tpu import ops
    from sheeprl_tpu.algos.ppo.agent import one_hot_to_env_actions
    from sheeprl_tpu.utils.checkpoint import latest_checkpoint, load_checkpoint
    from sheeprl_tpu.utils.registry import tasks

    recipe, _, env_id, _ = RECIPES[algo]
    agent = importlib.import_module(f"sheeprl_tpu.algos.{algo}.agent")
    args_mod = importlib.import_module(f"sheeprl_tpu.algos.{algo}.args")
    make_optimizers = importlib.import_module(f"sheeprl_tpu.algos.{algo}.{algo}").make_optimizers
    tasks[algo]([*recipe, "--seed", str(seed), "--root_dir", out, "--run_name", f"ref_{seed}"])
    ckpt = latest_checkpoint(os.path.join(out, f"ref_{seed}", "checkpoints"))
    env = gym.make(env_id)
    if algo == "dreamer_v1":
        args = args_mod.DreamerV1Args(env_id=env_id, seed=seed)
        args.dense_units = args.hidden_size = args.recurrent_state_size = 200
        args.stochastic_size = 30
        args.use_continues = False
        actions_dim, continuous, sizes = (1,), True, dict(stochastic_size=30, recurrent_state_size=200)
    else:
        args = getattr(args_mod, "DreamerV3Args" if algo == "dreamer_v3" else "DreamerV2Args")(env_id=env_id,
                                                                                             seed=seed)
        args.dense_units = args.hidden_size = args.recurrent_state_size = 256
        args.stochastic_size = args.discrete_size = 16
        actions_dim, continuous = (2,), False
        sizes = dict(stochastic_size=16, discrete_size=16, recurrent_state_size=256)
    args.cnn_keys, args.mlp_keys = [], ["state"]
    args.mlp_layers, args.horizon, args.action_repeat = 2, 15, 1
    models = agent.build_models(jax.random.PRNGKey(0), list(actions_dim), continuous, args,
                                {"state": env.observation_space}, [], ["state"])
    wm, actor, critic = models[:3]
    wopt, aopt, copt = make_optimizers(args)
    template = {"world_model": wm, "actor": actor, "critic": critic, "world_optimizer": wopt.init(wm),
                "actor_optimizer": aopt.init(actor), "critic_optimizer": copt.init(critic),
                "expl_decay_steps": 0, "global_step": 0, "batch_size": 0}
    if algo != "dreamer_v1":
        template["target_critic"] = models[3]
    if algo == "dreamer_v3":
        template["moments"] = ops.Moments.init(args.moments_decay, args.moment_max)
    restored = load_checkpoint(ckpt, template)
    player_cls = {"dreamer_v3": "PlayerDV3", "dreamer_v2": "PlayerDV2", "dreamer_v1": "PlayerDV1"}[algo]
    player = getattr(agent, player_cls)(encoder=restored["world_model"].encoder, rssm=restored["world_model"].rssm,
                                        actor=restored["actor"], actions_dim=actions_dim, is_continuous=continuous,
                                        **sizes)
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
            if continuous:
                act = np.asarray(actions)[0]
            else:
                act = one_hot_to_env_actions(np.asarray(actions), (2,), False)[0].item()
            obs, reward, terminated, truncated, _ = env.step(act)
            ret += float(reward)
            done = terminated or truncated
        returns.append(ret)
    env.close()
    return returns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--algo", choices=tuple(RECIPES), default="dreamer_v3")
    parser.add_argument("--package", choices=("port", "reference"), default="port")
    parser.add_argument("--device", default="cuda", help="the port's --device (the reference runs on the CPU)")
    parser.add_argument("--seeds", type=int, nargs="+", default=[5])
    parser.add_argument("--out", default=None, help="default build/<algo>_learning")
    parser.add_argument("--plain_kernels", nargs="*", choices=(*PLAIN_KERNELS, "all"), default=[],
                        help="run these kernels' plain PyTorch versions in their place (`use_plain_kernels`)")
    opts = parser.parse_args()
    out = opts.out or os.path.join(HERE, "build", "dv3_learning" if opts.algo == "dreamer_v3"
                                   else f"{opts.algo}_learning")
    bar = RECIPES[opts.algo][3]
    sys.path.insert(0, HERE)
    import numpy as np

    plain = sorted(PLAIN_KERNELS if "all" in opts.plain_kernels else set(opts.plain_kernels))
    use_plain_kernels(plain)
    for seed in opts.seeds:
        t0 = time.perf_counter()
        if opts.package == "port":
            returns = port_returns(seed, opts.device, out, opts.algo)
        else:
            returns = reference_returns(seed, out, opts.algo)
        mean = float(np.mean(returns))
        print(json.dumps({"algo": opts.algo, "package": opts.package, "plain_kernels": plain, "seed": seed,
                          "device": opts.device if opts.package == "port" else "cpu", "mean_return": mean,
                          "passes": mean >= bar, "bar": bar, "returns": returns,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
