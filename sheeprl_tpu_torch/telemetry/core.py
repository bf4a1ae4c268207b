"""A minimal JSONL telemetry writer (in place of the reference's
sheeprl_tpu/telemetry/core.py): named events and interval records that
merge the registered gauge sources, one JSON object per line in
`<log_dir>/telemetry.jsonl`.

Besides the writer, the reference's process-wide plumbing that
`telemetry/trace.py` needs (`core.py:56-70`): every open `Telemetry` is
registered, and the module-level `emit` publishes an event to each, so a
helper without a handle (the on-demand profile window) still leaves its
record. `Telemetry.tracer` is the shard's span emitter, built at first use.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

__all__ = ["Telemetry", "active_telemetry", "emit"]

_active: list["Telemetry"] = []


def active_telemetry() -> list["Telemetry"]:
    return list(_active)


def emit(event: str, **data: Any) -> None:
    """Publish an event to every open Telemetry; a no-op when none is open
    (tools, tests, bare library use)."""
    for t in list(_active):
        t.event(event, **data)


class Telemetry:
    FILENAME = "telemetry.jsonl"

    def __init__(self, log_dir: str, role: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.role = role
        self.enabled = True  # read by the tracer: a closed writer emits no span
        self._fh = open(os.path.join(log_dir, self.FILENAME), "a")
        self._lock = threading.Lock()
        self._gauges: list[Callable[[], dict[str, float]]] = []
        self._tracer = None
        _active.append(self)

    @property
    def tracer(self):
        """This shard's span emitter (`telemetry/trace.py:Tracer`)."""
        if self._tracer is None:
            from .trace import Tracer

            self._tracer = Tracer(self)
        return self._tracer

    def _write(self, record: dict[str, Any]) -> None:
        line = json.dumps({"t": time.time(), "role": self.role, **record}, default=str)
        with self._lock:
            if not self._fh.closed:
                self._fh.write(line + "\n")
                self._fh.flush()

    def event(self, event: str, **data: Any) -> None:
        self._write({"event": event, **data})

    def add_gauges(self, source: Callable[[], dict[str, float]]) -> None:
        self._gauges.append(source)

    def interval(self, metrics: dict[str, float], step: int, sps: float) -> None:
        merged = dict(metrics)
        for source in self._gauges:
            merged.update(source())
        self._write({"event": "interval", "step": step, "sps": sps, "metrics": merged})

    def close(self) -> None:
        self.enabled = False
        if self in _active:
            _active.remove(self)
        with self._lock:
            self._fh.close()
