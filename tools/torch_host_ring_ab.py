#!/usr/bin/env python3
"""DreamerV3's host-env step on the card, run against run: phase 6's command
(`chip_smoke.py`: DreamerV3's defaults at full width on `discrete_dummy`
pixels, one env) with its graphs captured at startup (`--warm_compile on`,
so that no player step pays a capture) and 200 player steps, each run in a
fresh process from the checkout it names. Reports each run's host wall a
player step while the player acts (the player's graph replay, the env step
and the replay rows written: 1000 / `policy_env_steps_per_s` of the "done"
record, one env) and its median gradient step.

    python3 tools/torch_host_ring_ab.py --runs before:build/earlier after:. after_ar1:.:--action_repeat=1

Each run is `label:checkout[:extra flag ...]` (flags joined by `:`), run in
the order given; `before:build/earlier` is an earlier commit unpacked with
`git archive`. One JSON line a run, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["dreamer_v3", "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "1", "--buffer_size", "512",
        "--learning_starts", "64", "--train_every", "8", "--pretrain_steps", "1", "--total_steps", "264",
        "--warm_compile", "on", "--checkpoint_every", "-1"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", nargs="+", required=True, help="label:checkout[:flag ...]")
    parser.add_argument("--out", default=os.path.join(HERE, "build", "ring_ab"))
    opts = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for i, spec in enumerate(opts.runs):
        label, tree, *extra = spec.split(":")
        root = os.path.abspath(os.path.join(opts.out, f"{i}_{label}"))
        cmd = [sys.executable, "-m", "sheeprl_tpu_torch", *ARGV, *extra, "--root_dir", root, "--run_name", "r"]
        proc = subprocess.run(cmd, cwd=os.path.abspath(tree), capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        with open(os.path.join(root, "r", "metrics.jsonl")) as fh:
            done = [json.loads(line) for line in fh][-1]
        print(json.dumps({
            "label": label, "checkout": tree, "extra": extra, "player_steps": done["player_steps"],
            "env_steps": done["env_steps"], "ms_per_player_step": 1000.0 / done["policy_env_steps_per_s"],
            "gradient_steps": done["gradient_steps"],
            "train_step_ms_median": statistics.median(done["train_step_ms"][1:]), "card": smi,
        }), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
