"""Evaluation shared by the mains (the port of sheeprl_tpu/utils/evaluation.py):
the merge of command-line flags into a config restored from a checkpoint
(`parse_run_args`), and the loop of greedy test episodes that ends every
run and is all that `--eval_only` runs."""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

import numpy as np

from .checkpoint import load_checkpoint_args
from .parser import DataclassArgumentParser

__all__ = ["apply_eval_overrides", "parse_run_args", "run_test_episodes", "validate_eval_args"]

# flags that pick where an evaluation goes, so the command line's value wins
# over the checkpoint's whatever was given: its device (a checkpoint written
# on the card evaluates on the CPU), a fresh seed, its own log directory and
# its episode count. The reference's `platform` and `num_devices` are the
# port's `device`; flags an algorithm's args lack are skipped.
_EVAL_CLI_FLAGS = ("test_episodes", "device", "seed", "root_dir", "run_name")

# training preferences that the checkpoint keeps unless the evaluation's
# command line gives them. The reference's one, `capture_video`, is not
# ported (the port records no video), so the tuple is empty.
_EVAL_CLI_IF_PROVIDED: tuple[str, ...] = ()


def validate_eval_args(args: Any) -> None:
    """Raise right after parsing, before any env or model is built, on an
    `--eval_only` that names no checkpoint."""
    if getattr(args, "eval_only", False) and args.checkpoint_path is None:
        raise ValueError("--eval_only requires --checkpoint_path")


def apply_eval_overrides(saved: dict[str, Any], args: Any) -> dict[str, Any]:
    """Merge the command line's flags (`args`, as parsed) into `saved`, the
    config restored from a checkpoint's sidecar; returns `saved`.

    Under `--eval_only` the flags of `_EVAL_CLI_FLAGS` override
    unconditionally, and those of `_EVAL_CLI_IF_PROVIDED` when given. On a
    training resume every flag the command line gave explicitly
    (`args._cli_provided`) overrides the sidecar, which fills the rest: a
    resume with `--total_steps 2N` trains on to the new budget."""
    provided = getattr(args, "_cli_provided", set())
    if getattr(args, "eval_only", False):
        saved["eval_only"] = True
        for f in _EVAL_CLI_FLAGS:
            if hasattr(args, f):
                saved[f] = getattr(args, f)
        for f in _EVAL_CLI_IF_PROVIDED:
            if f in provided:
                saved[f] = getattr(args, f)
    else:
        for f in provided - {"checkpoint_path", "eval_only"}:
            saved[f] = getattr(args, f)
    return saved


def parse_run_args(args_type: type, argv: Sequence[str] | None):
    """A main's config from its command line; with `--checkpoint_path`, the
    checkpoint's own config (its sidecar), the path kept and the command
    line's explicit flags over it (`apply_eval_overrides`)."""
    parser = DataclassArgumentParser(args_type)
    (args,) = parser.parse_args_into_dataclasses(argv)
    validate_eval_args(args)
    if args.checkpoint_path:
        if not os.path.isdir(args.checkpoint_path):
            raise FileNotFoundError(f"no checkpoint at {args.checkpoint_path}")
        saved = load_checkpoint_args(args.checkpoint_path)
        if saved:
            saved.update(checkpoint_path=args.checkpoint_path)
            apply_eval_overrides(saved, args)
            (args,) = parser.parse_dict(saved)
    return args


def run_test_episodes(episode_fn: Callable[[], float], args: Any, logger) -> list[float]:
    """Run `max(test_episodes, 1)` evaluation episodes and log each return
    (`Test/episode_reward`, step i) and, when more than one ran, their mean
    (`Test/mean_reward`). Episode i runs with `args.seed = base_seed + i`,
    restored afterwards: `episode_fn` reads `args.seed` on each call and
    builds its own env. -> the returns."""
    base_seed = args.seed
    rets: list[float] = []
    try:
        for i in range(max(args.test_episodes, 1)):
            args.seed = base_seed + i
            rets.append(episode_fn())
            logger.log("Test/episode_reward", rets[-1], i)
    finally:
        args.seed = base_seed
    if len(rets) > 1:
        logger.log("Test/mean_reward", float(np.mean(rets)), 0)
    return rets
