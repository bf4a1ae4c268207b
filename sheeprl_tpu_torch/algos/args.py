"""Base config dataclass shared by every task (the port of
sheeprl_tpu/algos/args.py, keeping the fields that serving and DreamerV3
read). `--device` takes the place of the reference's `--platform`.
Setting `log_dir` dumps `args.json` into the run directory."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

from ..utils.parser import Arg


@dataclasses.dataclass
class StandardArgs:
    seed: int = Arg(default=42, help="experiment PRNG seed")
    dry_run: bool = Arg(default=False, help="run one tiny iteration of everything and exit")
    env_id: str = Arg(default="CartPole-v1", help="environment id")
    root_dir: Optional[str] = Arg(default=None, help="root folder for logs of this experiment")
    run_name: Optional[str] = Arg(default=None, help="folder name of this run")
    screen_size: int = Arg(default=64, help="side of pixel observations")
    frame_stack: int = Arg(default=-1, help="frames to stack for pixel observations")
    device: str = Arg(
        default="cuda",
        help="torch device to run on: 'cuda' (the default; raises when CUDA is "
        "missing) or 'cpu'",
    )
    precision: str = Arg(
        default="float32",
        help="compute dtype of the network forward (float32|bfloat16)",
    )

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "precision" and value not in ("float32", "bfloat16"):
            raise ValueError(
                f"precision must be 'float32' or 'bfloat16', got {value!r}"
            )
        super().__setattr__(name, value)
        if name == "log_dir" and value:
            os.makedirs(value, exist_ok=True)
            with open(os.path.join(value, "args.json"), "w") as fh:
                json.dump(self.as_dict(), fh)

    def as_dict(self) -> dict[str, Any]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.init
        }
