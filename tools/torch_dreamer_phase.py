#!/usr/bin/env python3
"""`chip_smoke.py`'s phase 17 alone: DreamerV2 and DreamerV1 on the card at
their default widths (DreamerV2 on discrete_dummy pixels and, with the
episode buffer and `--prioritize_ends`, on Pendulum-v1; DreamerV1 on
continuous_dummy pixels), each run counted on the device (no port kernel
on either path), the pixel runs resumed from their step-68 checkpoints, one
gradient step of each on the card against the CPU, and each graphed step
against its eager self, bit for bit, the graphs timed. It builds the
kernels first. Run from the root of a checkout, on one card:

    python3 tools/torch_dreamer_phase.py [--out DIR]

The phase's lines go to stdout, its report to DIR/dreamer.json. Exits
non-zero without a card or when a check of the phase fails.
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
    parser.add_argument("--out", default=os.path.join(HERE, "build", "dreamer_phase"),
                        help="directory for the report and the runs' logs")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_dreamer_phase: needs a CUDA card", file=sys.stderr)
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
    out = cs.dreamer_phase(torch, np, run, torch.device("cuda"), smi)
    with open(os.path.join(cs.OUT_DIR, "dreamer.json"), "w") as fh:
        json.dump(out, fh, default=str)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
