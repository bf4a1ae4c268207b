#!/usr/bin/env python3
"""`chip_smoke.py`'s phase 14 alone: DreamerV3 with continuous actions on
the card (the continuous_dummy pixel run with its exact launch counts,
one gradient step card vs CPU, the graphed step timed, `serve --ckpt`
with every answer against its rung's direct call, `--eval_only` and the
greedy best-of-100 episodes, the device Pendulum run and its chunk's
replay against its eager self), in ~3 minutes instead of the whole smoke
run's ~14. It builds the kernels first. Run from the root of a checkout,
on one card:

    python3 tools/torch_continuous_phase.py [--out DIR]

The phase's lines go to stdout, its report to DIR/continuous.json (the
run directories under DIR hold checkpoints of ~0.2 GB). Exits non-zero
without a card or when a check of the phase fails.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(HERE, "build", "continuous_phase"),
                        help="directory for the report and the runs' logs")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_continuous_phase: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops.kernels import build
    from sheeprl_tpu_torch.serve.client import ServeClient

    cs.OUT_DIR = os.path.abspath(args.out)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    gc.callbacks.append(cs.GC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    smi = cs.smi_line()
    # phase 6's median gradient step is not measured here
    out = cs.continuous_phase(torch, np, run, ServeClient, torch.device("cuda"), smi,
                              {"train": {"step_ms_median": float("nan")}})
    with open(os.path.join(cs.OUT_DIR, "continuous.json"), "w") as fh:
        json.dump(out, fh, default=str)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
