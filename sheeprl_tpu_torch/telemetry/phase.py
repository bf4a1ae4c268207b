"""Hierarchical phase timers (the port of sheeprl_tpu/telemetry/phase.py):
where a training iteration's host time goes.

Two ways into one accumulator:

  - `with timers.phase("train"):` nests; a nested phase is named
    `train/dispatch`, and its time counts for both it and its parent. The
    time up to an exception is still recorded.
  - `timers.mark("rollout")` sections a main's loop linearly: each mark
    ends the marked section before it and opens the named one;
    `mark(None)` only ends.

`flush()` returns the seconds of each phase since the last flush and
restarts every phase still open at now (an open phase's elapsed time goes
to the flushed interval and it keeps running), so no interval loses or
double-counts time. Host clock only: a phase that launches device work
without waiting for it measures the launch.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Iterator

__all__ = ["PhaseTimers"]


class PhaseTimers:
    def __init__(self) -> None:
        self._acc: dict[str, float] = {}
        self._stack: list[tuple[str, float]] = []  # (full name, start) of the open `phase`s
        self._mark: tuple[str, float] | None = None  # the open `mark` section

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        full = f"{self._stack[-1][0]}/{name}" if self._stack else name
        self._stack.append((full, time.perf_counter()))
        try:
            yield
        finally:
            fname, t0 = self._stack.pop()
            self._acc[fname] = self._acc.get(fname, 0.0) + (time.perf_counter() - t0)

    def mark(self, name: str | None) -> None:
        """End the marked section (if any) and open `name`."""
        now = time.perf_counter()
        if self._mark is not None:
            prev, t0 = self._mark
            self._acc[prev] = self._acc.get(prev, 0.0) + (now - t0)
        self._mark = (name, now) if name is not None else None

    def flush(self) -> dict[str, float]:
        """Seconds a phase since the last flush; open phases contribute
        their elapsed time and restart at now."""
        now = time.perf_counter()
        out = dict(self._acc)
        self._acc.clear()
        if self._mark is not None:
            name, t0 = self._mark
            out[name] = out.get(name, 0.0) + (now - t0)
            self._mark = (name, now)
        for i, (name, t0) in enumerate(self._stack):
            out[name] = out.get(name, 0.0) + (now - t0)
            self._stack[i] = (name, now)
        return out
