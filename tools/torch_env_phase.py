#!/usr/bin/env python3
"""`chip_smoke.py`'s phase 16 alone: the env and logging layer on the card
(DreamerV3 at full width on pixeltoy's gray frames through 4 env worker
processes, each action repeated twice and episodes cut at 100 env steps,
`--remat on` and a `--profile` window; the same run counted on the device;
kernels 3 and 3-res at Cin = 1 against their plain versions; one gradient
step under `--remat off`, `on` and `policy` from one state, bit for bit,
with each mode's peak memory and time, and `--remat auto`'s decision), in
about a minute instead of the whole smoke run's ~16. It builds the kernels
first. Run from the root of a checkout, on one card:

    python3 tools/torch_env_phase.py [--out DIR]

The phase's lines go to stdout, its report to DIR/env.json. Exits non-zero
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
    parser.add_argument("--out", default=os.path.join(HERE, "build", "env_phase"),
                        help="directory for the report and the runs' logs")
    args = parser.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_env_phase: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops.kernels import build

    cs.OUT_DIR = os.path.abspath(args.out)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    gc.callbacks.append(cs.GC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    smi = cs.smi_line()
    out = cs.env_layer_phase(torch, np, F, run, torch.device("cuda"), smi)
    with open(os.path.join(cs.OUT_DIR, "env.json"), "w") as fh:
        json.dump(out, fh, default=str)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
