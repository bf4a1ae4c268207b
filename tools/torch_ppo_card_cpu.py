#!/usr/bin/env python3
"""`chip_smoke.py` phase 10's pixel PPO update, card against CPU, over
repeated runs: free-running, as the phase holds it, and teacher-forced.

Each run trains `ppo` on pixels as phase 10 does (`PPO_PIXEL_ARGV`, 2
updates on the card), then takes one update from its last checkpoint on
the card and on the CPU, from the same rollout and permutations
(`ppo_update_check`'s inputs):

- free-running: each device runs its 80 Adam steps on its own parameters;
  the gap is the phase's statistic (the largest parameter difference over
  that parameter's largest magnitude, gated there at `PPO_PARAM_TOL`);
- teacher-forced: before each step the card's parameters are set to the
  CPU's, each optimizer keeps its own state; a step's gap is the
  difference of the two deltas over the parameter's largest magnitude,
  and `forced_sum` sums each parameter's gaps over the steps (a bound on
  the free-running gap while the two trajectories do not part), its
  largest parameter's sum reported. `fc_flips` counts the steps whose
  encoder `fc` pre-activations differ in sign between the two devices.

One JSON line a run, then the card's name and power limit. Run from the
root of a checkout, on one card:

    python3 tools/torch_ppo_card_cpu.py --runs 30
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--runs", type=int, default=30, help="pixel PPO runs, each with its update held")
    parser.add_argument("--out", default=os.path.join(HERE, "build", "ppo_card_cpu"),
                        help="directory for the runs (emptied first)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_ppo_card_cpu: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from sheeprl_tpu_torch.algos.ppo import ppo
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py's phase 1
    torch.backends.cudnn.allow_tf32 = False
    card, cpu = torch.device("cuda"), torch.device("cpu")
    shutil.rmtree(args.out, ignore_errors=True)

    def inputs(ckpt):
        ppo_args, agent, _, envs, keys = cs._ppo_state(torch, ckpt, cpu)
        rb = ReplayBuffer(ppo_args.rollout_steps, ppo_args.num_envs, device=cpu, obs_keys=keys)
        rollout = ppo.Rollout(envs, 77)
        rollout.collect(agent, rb, keys, torch.Generator().manual_seed(0))
        batch = ppo.rollout_batch(agent, rb, rollout, keys, ppo_args)
        n = batch["logprobs"].shape[0]
        gen = torch.Generator().manual_seed(1)
        perms = torch.stack([torch.randperm(n, generator=gen) for _ in range(ppo_args.update_epochs)])
        return ppo_args, batch, perms, max(n // ppo_args.per_rank_batch_size, 1)

    def scalars(ppo_args, device):
        return [torch.full((), float(v), device=device) for v in (ppo_args.lr, ppo_args.clip_coef, ppo_args.ent_coef)]

    def forced(ckpt, ppo_args, batch, perms, nb):
        _, host, host_opt, _, _ = cs._ppo_state(torch, ckpt, cpu)
        _, dev, dev_opt, _, _ = cs._ppo_state(torch, ckpt, card)
        z = {}
        for name, agent in (("cpu", host), ("card", dev)):
            fc = getattr(getattr(getattr(agent, "cnn_encoder", None), "model", None), "fc", None)
            if fc is not None:
                fc.register_forward_hook(lambda m, i, o, name=name: z.__setitem__(name, o.detach().cpu()))
        step = ppo.make_train_step(ppo_args, nb).minibatch_step
        mb = batch["logprobs"].shape[0] // nb
        dev_batch = {k: v.to(card) for k, v in batch.items()}
        sums, worst, flips = {}, 0.0, 0
        for epoch in range(ppo_args.update_epochs):
            for idx in perms[epoch][: nb * mb].reshape(nb, mb):
                before = {k: v.detach().clone() for k, v in host.state_dict().items()}
                dev.load_state_dict(before)
                step(dev, dev_opt, dev_batch, idx.to(card), *scalars(ppo_args, card))
                step(host, host_opt, batch, idx, *scalars(ppo_args, cpu))
                after = host.state_dict()
                for k, v in dev.state_dict().items():
                    gap = float(((v.cpu() - before[k]) - (after[k] - before[k])).abs().max())
                    sums[k] = sums.get(k, 0.0) + gap
                    worst = max(worst, gap / float(after[k].abs().max().clamp_min(1e-12)))
                flips += bool(z) and bool(((z["cpu"] > 0) != (z["card"] > 0)).any())
        final = host.state_dict()
        rel = {k: s / float(final[k].abs().max().clamp_min(1e-12)) for k, s in sums.items()}
        top = max(rel, key=rel.get)
        return dict(forced_step_max=worst, forced_sum=rel[top], forced_sum_param=top, fc_flips=flips)

    bad = 0
    for i in range(args.runs):
        cs.drive_ppo(run, args.out, cs.PPO_PIXEL_ARGV, f"pixels{i}")
        ckpt = os.path.join(args.out, f"pixels{i}", "checkpoints", "ckpt_2")
        c = cs.ppo_update_check(torch, ckpt, card)
        row = {"run": i, "param_err": c["param_err"], "loss_rel": c["loss_rel"],
               "value_loss": c["cpu"]["Loss/value_loss"], "over_gate": c["param_err"] > cs.PPO_PARAM_TOL}
        bad += row["over_gate"]
        if i == 0 or row["over_gate"]:  # the first run, and every run past the gate
            row.update(forced(ckpt, *inputs(ckpt)))
        print(json.dumps(row), flush=True)
    print(json.dumps({"runs": args.runs, "over_gate": bad}), flush=True)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
