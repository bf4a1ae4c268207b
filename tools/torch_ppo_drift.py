#!/usr/bin/env python3
"""How far the port's PPO follows the reference's when both take the same
data: the reference's PPO loop (its policy step, GAE and `make_train_step`)
drives CartPole-v1 (the port's host copy) with the learning recipe of
tests/test_algos/test_learning.py; the port's agent, carried over from the
reference's initial parameters, scores the same rollouts (its own log-probs
and values) and takes the same updates with the reference's permutations.
Prints, per update, the largest difference of the rollout log-probs, the
largest parameter difference over that parameter's largest magnitude, and
both sides' losses; at the end each side's greedy return at seeds
1000-1009. On the CPU (JAX and the reference needed):

    python tools/torch_ppo_drift.py --updates 128 [--seed 5]

The port's own rollouts are not used, so past the update where the
parameters part, the port trains on another policy's actions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, N, MINIBATCHES, EPOCHS = 128, 4, 4, 6


def greedy_returns(act) -> list[float]:
    from sheeprl_tpu_torch.envs.cartpole import CartPole

    returns = []
    for ep in range(10):
        env = CartPole(0)
        obs, _ = env.reset(seed=1000 + ep)
        done, ret = False, 0.0
        while not done:
            obs, r, term, trunc, _ = env.step(act(obs))
            ret, done = ret + r, term or trunc
        returns.append(ret)
    return returns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--updates", type=int, default=128)
    parser.add_argument("--seed", type=int, default=5)
    opts = parser.parse_args()
    sys.path.insert(0, HERE)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import gymnasium as gym
    import jax.numpy as jnp
    import numpy as np
    import torch

    from sheeprl_tpu.algos.ppo import ppo as R
    from sheeprl_tpu.algos.ppo.agent import PPOAgent as RefAgent
    from sheeprl_tpu.algos.ppo.args import PPOArgs as RefArgs
    from sheeprl_tpu_torch.algos.ppo import ppo as P
    from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent
    from sheeprl_tpu_torch.algos.ppo.args import PPOArgs
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.cartpole import CartPole
    from sheeprl_tpu_torch.interop import flatten_params, ppo_agent_from_jax
    from sheeprl_tpu_torch.ops.math import polynomial_decay

    def flat(tree) -> dict:
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        part = lambda k: str(next(getattr(k, a) for a in ("name", "idx", "key") if hasattr(k, a)))  # noqa: E731
        return {".".join(part(k) for k in path): np.asarray(leaf) for path, leaf in leaves}

    kw = dict(rollout_steps=T, num_envs=N, per_rank_batch_size=T * N // MINIBATCHES, update_epochs=EPOCHS,
              ent_coef=0.01, anneal_lr=True, normalize_advantages=True, max_grad_norm=0.5, cnn_keys=[],
              mlp_keys=["state"])
    rargs, args = RefArgs(**kw), PPOArgs(**kw, device="cpu")
    ragent = RefAgent.init(jax.random.PRNGKey(opts.seed), [2],
                           {"state": gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)}, [], ["state"])
    agent = ppo_agent_from_jax(PPOAgent([2], {"state": spaces.Box(-1, 1, (4,))}, [], ["state"]), flat(ragent))
    optax_opt = R.make_optimizer(rargs)
    state = R.TrainState(agent=ragent, opt_state=optax_opt.init(ragent))
    ref_step, step = R.make_train_step(rargs, optax_opt, MINIBATCHES), P.make_train_step(args, MINIBATCHES)
    optimizer = P.make_optimizer(args, agent)
    envs = [CartPole(opts.seed + i) for i in range(N)]
    obs = np.stack([env.reset(seed=opts.seed + i)[0] for i, env in enumerate(envs)])
    next_done, key = np.zeros(N, np.float32), jax.random.PRNGKey(opts.seed)
    for update in range(1, opts.updates + 1):
        lr = polynomial_decay(update, initial=args.lr, final=0.0, max_decay_steps=65536 // (T * N))
        rows = {k: [] for k in ("state", "actions", "logprobs", "values", "rewards", "dones", "port_lp", "port_v")}
        for _ in range(T):
            key, sub = jax.random.split(key)
            actions, logprob, value, env_idx = R.policy_step(state.agent, {"state": jnp.asarray(obs)}, sub)
            with torch.no_grad():
                _, lp, _, v = agent({"state": torch.from_numpy(obs)}, actions=torch.from_numpy(np.array(actions)))
            rewards, dones, new = np.zeros(N, np.float32), np.zeros(N, np.float32), []
            for i, env in enumerate(envs):
                o, r, term, trunc, _ = env.step(int(np.asarray(env_idx)[i, 0]))
                rewards[i], dones[i] = r, float(term or trunc)
                new.append(env.reset()[0] if dones[i] else o)
            for k, val in (("state", obs), ("actions", actions), ("logprobs", logprob), ("values", value),
                           ("rewards", rewards[:, None]), ("dones", next_done[:, None]), ("port_lp", lp.numpy()),
                           ("port_v", v.numpy())):
                rows[k].append(np.asarray(val))
            next_done, obs = dones, np.stack(new)
        data = {k: np.stack(v) for k, v in rows.items()}
        returns, adv = R.compute_gae_returns(
            state.agent, {k: jnp.asarray(data[k]) for k in ("rewards", "values", "dones")},
            {"state": jnp.asarray(obs)}, jnp.asarray(next_done)[:, None], jnp.float32(0.99), jnp.float32(0.95))
        port = {k: torch.from_numpy(data[k]) for k in ("state", "actions", "rewards", "dones")}
        port["logprobs"], port["values"] = torch.from_numpy(data["port_lp"]), torch.from_numpy(data["port_v"])
        p_returns, p_adv = P.compute_gae_returns(agent, port, {"state": torch.from_numpy(obs)},
                                                 torch.from_numpy(next_done)[:, None], 0.99, 0.95)
        key, train_key = jax.random.split(key)
        perms = np.stack([np.asarray(jax.random.permutation(k, T * N)) for k in jax.random.split(train_key, EPOCHS)])
        ref_batch = {k: jnp.asarray(data[k].reshape(T * N, -1)) for k in ("state", "actions", "logprobs", "values")}
        ref_batch.update(returns=returns.reshape(-1, 1), advantages=adv.reshape(-1, 1))
        state, ref_m = ref_step(state, ref_batch, train_key, jnp.float32(lr), jnp.float32(0.2), jnp.float32(0.01))
        batch = {k: v.reshape(T * N, -1) for k, v in port.items() if k not in ("rewards", "dones")}
        batch.update(returns=p_returns.reshape(-1, 1), advantages=p_adv.reshape(-1, 1))
        m = step(agent, optimizer, batch, lr, 0.2, 0.01, perms=torch.from_numpy(perms))
        want = flatten_params(flat(state.agent))
        err = max(float(np.abs((p.detach().numpy().T if p.ndim == 2 else p.detach().numpy()) - want[n]).max()
                        / np.abs(want[n]).max()) for n, p in agent.named_parameters())
        lp_diff = float(np.abs(data["port_lp"] - data["logprobs"]).max())
        print(json.dumps({"update": update, "logprob_max_diff": lp_diff, "param_rel_err": err,
                          "reference": {k: float(ref_m[k]) for k in m}, "port": m}), flush=True)
    ref_greedy = jax.jit(state.agent.get_greedy_actions)
    print(json.dumps({
        "reference_greedy": greedy_returns(
            lambda o: int(np.asarray(ref_greedy({"state": jnp.asarray(o[None])}))[0].argmax())),
        "port_greedy": greedy_returns(
            lambda o: int(agent.get_greedy_actions({"state": torch.from_numpy(o[None])}).detach()[0].argmax())),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
