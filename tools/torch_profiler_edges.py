#!/usr/bin/env python3
"""What a torch.profiler window on the card keeps at its edges, with and
without `chip_smoke.py:DeviceLaunches`'s padding.

Runs the training of `chip_smoke.py` phase 6 (DreamerV3 at full width
through the CLI, 10 gradient steps and 13 player steps) `--runs` times in
each of two windows:

- `bare`: 512 empty kernels at each edge, synchronized, and nothing else
  (the window `DeviceLaunches` opened before its edges were padded);
- `padded`: `DeviceLaunches` as it is, each edge padded with host idle and
  slack kernels outside its empty ones.

For each run: the empty and slack kernels each edge kept, and whether the
port's kernels were counted exactly (`check_train_launches`). One JSON
line a run, then the card's name and power limit. Run from the root of a
checkout, on one card:

    python3 tools/torch_profiler_edges.py --runs 3

Exits non-zero without a card, or when a padded window lost an empty
kernel or counted inexactly.
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
    parser.add_argument("--runs", type=int, default=3, help="training runs in each window")
    parser.add_argument("--out", default=os.path.join(HERE, "build", "profiler_edges"),
                        help="directory for the runs' logs (emptied first)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_profiler_edges: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops.kernels import build

    class Bare(cs.DeviceLaunches):
        EDGE_PAD_S, EDGE_SLACK = 0.0, 0

    build.build_all()
    shutil.rmtree(args.out, ignore_errors=True)
    bad = 0
    for layout, window in (("bare", Bare), ("padded", cs.DeviceLaunches)):
        for i in range(args.runs):
            cs.DeviceLaunches, saved = (lambda t, names: window(t, names, strict=False)), cs.DeviceLaunches
            try:
                launches, _, done, wrapper = cs.drive_train(torch, run, args.out, run_name=f"{layout}{i}")
            finally:
                cs.DeviceLaunches = saved
            try:
                cs.check_train_launches(layout, launches, wrapper, cs.PER_GRADIENT_STEP, cs.PER_PLAYER_STEP, done)
                exact = True
            except RuntimeError:
                exact = False
            edges = window.WINDOWS[-1]
            lost = 2 * window.EDGE_MARGIN - edges["head"]["empty"] - edges["tail"]["empty"]
            bad += layout == "padded" and (lost or not exact)
            print(json.dumps({"layout": layout, "run": i, "edges": edges, "empty_lost": lost, "exact": exact,
                              "launches": launches}), flush=True)
    print(cs.smi_line(), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
