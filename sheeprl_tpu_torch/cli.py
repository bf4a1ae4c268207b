"""CLI launcher: `python -m sheeprl_tpu_torch <task> [--flags]` (the port of
sheeprl_tpu/cli.py)."""

from __future__ import annotations

import sys

from .utils.registry import tasks


def _print_usage() -> None:
    print("usage: sheeprl_tpu_torch <task> [--flags] | sheeprl_tpu_torch --help")
    print("\navailable tasks:")
    for name in sorted(tasks):
        print(f"  {name}")


def run(argv: list[str] | None = None) -> None:
    from . import algos  # noqa: F401 -- imports fire @register_algorithm

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        _print_usage()
        return
    task = argv[0]
    if task not in tasks:
        print(f"unknown task {task!r}", file=sys.stderr)
        _print_usage()
        raise SystemExit(2)
    tasks[task](argv[1:])
