"""A bounded profiler window over training iterations (the port of
sheeprl_tpu/utils/profiler.py), on `torch.profiler`.

`StepProfiler` traces a window of update calls: the first `tick()` starts
`torch.profiler` (CPU activity, and CUDA activity when the process has a
card), the `steps + 1`-th stops it. Starting and stopping each first
synchronize the device, so the trace holds the kernels of exactly the
`steps` updates (a graph replay's too) and the work between them, then
stopping writes a chrome trace, `<profile_dir>/trace.json`, viewable in
Perfetto or chrome://tracing. Inactive (`profile_dir=None`) it does
nothing. `close()` stops a window that is still open at the end of a run,
and an atexit hook registered when the window starts flushes it after a
crash. `profile.start` and `profile.stop` events go to the run's
telemetry (`telemetry/core.py:emit`).
"""

from __future__ import annotations

import atexit
import os

import torch

from ..telemetry.core import emit

__all__ = ["TRACE_FILE", "StepProfiler"]

TRACE_FILE = "trace.json"


class StepProfiler:
    def __init__(self, profile_dir: str | None, steps: int = 5):
        self._dir = profile_dir
        self._steps = max(int(steps), 1)
        self._seen = 0
        self._prof = None
        self._done = profile_dir is None

    @classmethod
    def from_args(cls, args, log_dir: str, rank: int = 0) -> "StepProfiler":
        """The mains' construction: a window on process 0 only, into
        `<log_dir>/profile`, when `--profile` is given."""
        enabled = getattr(args, "profile", False) and rank == 0
        return cls(os.path.join(log_dir, "profile") if enabled else None, getattr(args, "profile_steps", 5))

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def trace_path(self) -> str | None:
        return None if self._dir is None else os.path.join(self._dir, TRACE_FILE)

    def tick(self) -> None:
        """Call once after each update call."""
        if self._done:
            return
        if self._prof is None:
            os.makedirs(self._dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                # the window opens after the work launched before it is done
                torch.cuda.synchronize()
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            atexit.register(self.close)
            emit("profile.start", dir=self._dir, steps=self._steps)
            return
        self._seen += 1
        if self._seen >= self._steps:
            self.close()

    def close(self) -> None:
        prof, self._prof = self._prof, None
        self._done = True
        if prof is None:
            return
        atexit.unregister(self.close)
        try:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        finally:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(self.trace_path)
            emit("profile.stop", dir=self._dir, trace=self.trace_path, updates=self._seen)
