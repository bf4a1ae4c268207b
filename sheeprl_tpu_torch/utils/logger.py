"""A run's directory and its metrics log (the port of
sheeprl_tpu/utils/logger.py's `create_logger`): the reference logs to
TensorBoard, the port appends one JSON object a record to
`<run_dir>/metrics.jsonl`."""

from __future__ import annotations

import json
import os
import time
from typing import Any

__all__ = ["JsonlLogger", "create_logger"]


class JsonlLogger:
    """Appends records to `<run_dir>/metrics.jsonl`: `record(dict)` as it
    is, `log(name, value, step)` as `{name: value, "step": step}`."""

    def __init__(self, run_dir: str):
        self.path = os.path.join(run_dir, "metrics.jsonl")

    def record(self, rec: dict[str, Any]) -> None:
        with open(self.path, "a") as fh:
            fh.write(json.dumps(rec) + "\n")

    def log(self, name: str, value: Any, step: int) -> None:
        self.record({name: value, "step": step})


def create_logger(args: Any, algo: str) -> tuple[JsonlLogger, str]:
    """The run's directory and logger: a resumed run (`--checkpoint_path`)
    writes on in its checkpoint's run directory, unless it is an
    `--eval_only` given its own `--root_dir`; any other run in
    `<root_dir>/<run_name>` (`logs/<algo>/<time>` by default). Sets
    `args.root_dir`, `args.run_name` and `args.log_dir`, which dumps the
    config (`args.json`, or `eval_args.json` under `--eval_only`).
    -> (logger, run directory)."""
    if args.checkpoint_path and not (getattr(args, "eval_only", False) and args.root_dir):
        run_dir = os.path.dirname(os.path.dirname(os.path.abspath(args.checkpoint_path)))
        root_dir, run_name = os.path.dirname(run_dir), os.path.basename(run_dir)
    else:
        root_dir = args.root_dir or os.path.join("logs", algo)
        run_name = args.run_name or time.strftime("%Y-%m-%d_%H-%M-%S")
        run_dir = os.path.join(root_dir, run_name)
    args.root_dir, args.run_name = root_dir, run_name
    args.log_dir = run_dir
    return JsonlLogger(run_dir), run_dir
