"""A minimal JSONL telemetry writer (in place of the reference's
sheeprl_tpu/telemetry/core.py): named events and interval records that
merge the registered gauge sources, one JSON object per line in
`<log_dir>/telemetry.jsonl`."""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable

__all__ = ["Telemetry"]


class Telemetry:
    def __init__(self, log_dir: str, role: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.role = role
        self._fh = open(os.path.join(log_dir, "telemetry.jsonl"), "a")
        self._lock = threading.Lock()
        self._gauges: list[Callable[[], dict[str, float]]] = []

    def _write(self, record: dict[str, Any]) -> None:
        line = json.dumps({"t": time.time(), "role": self.role, **record}, default=str)
        with self._lock:
            if not self._fh.closed:
                self._fh.write(line + "\n")
                self._fh.flush()

    def event(self, name: str, **data: Any) -> None:
        self._write({"event": name, **data})

    def add_gauges(self, source: Callable[[], dict[str, float]]) -> None:
        self._gauges.append(source)

    def interval(self, metrics: dict[str, float], step: int, sps: float) -> None:
        merged = dict(metrics)
        for source in self._gauges:
            merged.update(source())
        self._write({"event": "interval", "step": step, "sps": sps, "metrics": merged})

    def close(self) -> None:
        with self._lock:
            self._fh.close()
