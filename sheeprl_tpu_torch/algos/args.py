"""Base config dataclass shared by every task (the port of
sheeprl_tpu/algos/args.py, keeping the fields that serving, training,
checkpointing and evaluation read). `--device` takes the place of the
reference's `--platform`. `--env_backend` keeps the reference's values
(`host|jax`): `jax` runs the env's batched twin on the run's device
(`envs/device/`), in `ppo` and `dreamer_v3`; the other tasks ignore it, as
the reference's do. Setting `log_dir` dumps `args.json` into the run
directory (`eval_args.json` under `--eval_only`)."""

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
    num_envs: int = Arg(default=4, help="number of parallel environments")
    root_dir: Optional[str] = Arg(default=None, help="root folder for logs of this experiment")
    run_name: Optional[str] = Arg(default=None, help="folder name of this run")
    checkpoint_every: int = Arg(default=100, help="checkpoint period in policy steps; -1 disables")
    checkpoint_path: Optional[str] = Arg(default=None, help="checkpoint to resume from")
    eval_only: bool = Arg(
        default=False,
        help="skip training: load --checkpoint_path and run --test_episodes "
        "greedy evaluation episodes",
    )
    test_episodes: int = Arg(default=1, help="evaluation episodes for --eval_only")
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
    warm_compile: str = Arg(
        default="off",
        help="whole-step CUDA graphs (compile/plan.py): on the card every hot "
        "step (train step, player and policy steps, the minibatch step) runs "
        "as one replayed graph either way; 'on' warms up and captures each at "
        "startup from example arguments, 'off' (the default) at its first "
        "call. A call whose shapes differ from the capture's runs eagerly and "
        "counts Compile/aot_fallbacks. On the CPU the steps run directly",
    )

    env_backend: str = Arg(
        default="host",
        help="where the environments live: 'host' steps the port's host envs "
        "one by one (the default), 'jax' (the reference's name, kept so its "
        "configs carry across) runs the batched twin of env_id (envs/device/: "
        "CartPole-v1, Pendulum-v1, pixeltoy) on the run's device and collects "
        "a whole rollout as one CUDA graph replay. Read by ppo and dreamer_v3",
    )

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "precision" and value not in ("float32", "bfloat16"):
            raise ValueError(
                f"precision must be 'float32' or 'bfloat16', got {value!r}"
            )
        if name == "warm_compile" and value not in ("on", "off"):
            raise ValueError(f"warm_compile must be 'on' or 'off', got {value!r}")
        if name == "env_backend" and value not in ("host", "jax"):
            raise ValueError(f"env_backend must be 'host' or 'jax', got {value!r}")
        super().__setattr__(name, value)
        if name == "log_dir" and value:
            os.makedirs(value, exist_ok=True)
            # an evaluation logging into a training run's directory must not
            # overwrite the run's config record
            fname = "eval_args.json" if getattr(self, "eval_only", False) else "args.json"
            with open(os.path.join(value, fname), "w") as fh:
                json.dump(self.as_dict(), fh)

    def as_dict(self) -> dict[str, Any]:
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.init
        }
