#!/usr/bin/env python3
"""`chip_smoke.py`'s phase 15 alone: the rest of the serving tier on the
card (DreamerV3 `serve --quant int8` at full width with its launches
counted on the device and every answer against its rung's direct call, the
ladder sized from measured peaks and a budget that refuses rung 8, SAC's
occupancy re-tier, `--reload_poll_s`, a PROFILE window's trace and the
request spans), after phase 6's training run, which writes the checkpoints
it serves (its step-68 and step-72 checkpoints), in a few minutes instead
of the whole smoke run's ~15. It builds the kernels first. Run from the
root of a checkout, on one card:

    python3 tools/torch_tier_phase.py [--out DIR]

The phase's lines go to stdout, its report to DIR/tier.json (the run
directories under DIR hold checkpoints of ~0.5 GB). Exits non-zero without
a card or when a check of the phase fails.
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
    parser.add_argument("--out", default=os.path.join(HERE, "build", "tier_phase"),
                        help="directory for the report and the runs' logs")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_tier_phase: needs a CUDA card", file=sys.stderr)
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
    train_root = os.path.join(cs.OUT_DIR, "train_logs")
    cs.shutil.rmtree(train_root, ignore_errors=True)
    cs.drive_train(torch, run, train_root)  # phase 6's run: its checkpoints at steps 68 and 72
    out = cs.tier_phase(torch, np, run, ServeClient, torch.device("cuda"), train_root, smi)
    with open(os.path.join(cs.OUT_DIR, "tier.json"), "w") as fh:
        json.dump(out, fh, default=str)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
