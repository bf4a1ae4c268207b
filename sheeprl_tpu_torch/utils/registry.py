"""Task registry: maps task names to their `main()` entry points (the port
of sheeprl_tpu/utils/registry.py). Importing `sheeprl_tpu_torch.algos`
fires every `@register_algorithm()` decorator."""

from __future__ import annotations

from typing import Any, Callable

# task name -> entry point callable (the task's `main`)
tasks: dict[str, Callable[..., Any]] = {}


def register_algorithm(name: str | None = None):
    """Decorator registering a `main()` as a CLI task. The task name
    defaults to the defining module's last path component."""

    def inner(fn: Callable[..., Any]) -> Callable[..., Any]:
        task = name or fn.__module__.rsplit(".", 1)[-1]
        if task in tasks:
            raise ValueError(f"algorithm {task!r} already registered")
        tasks[task] = fn
        return fn

    return inner
