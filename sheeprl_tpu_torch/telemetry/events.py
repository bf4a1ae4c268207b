"""The structured JSONL event log (the port of sheeprl_tpu/telemetry/events.py):
`<log_dir>/telemetry.jsonl`, one self-describing line an event:

    {"ts": <unix seconds>, "event": "<name>", ...payload}

Each write is one `write()` of one line and a flush, so a crash loses at
most the event being written. Span events (`span`, `trace.clock`), which a
serving process writes a few a request, flush lazily: at most every 0.25 s,
and at the next other event or the close. Values that JSON cannot hold
(tensors, numpy scalars) become floats, and non-finite floats their
`repr`, so a strict parser reads every line. A full disk or a closed file
never raises into the caller. Writes from several threads are serialized.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any

__all__ = ["JsonlEventLog"]

_LAZY_FLUSH_EVENTS = frozenset({"span", "trace.clock"})
_LAZY_FLUSH_S = 0.25


def _jsonable(value: Any):
    if isinstance(value, bool) or value is None or isinstance(value, (int, str)):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else repr(value)
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    try:
        return _jsonable(float(value))
    except (TypeError, ValueError, RuntimeError):
        return repr(value)


class JsonlEventLog:
    """Appends events to `path`; with `path=None` it writes nothing."""

    def __init__(self, path: str | None):
        self.path = path
        self._fh = None
        self._last_flush = 0.0
        self._lock = threading.Lock()
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def emit(self, event: str, **data: Any) -> None:
        if self._fh is None:
            return
        record = {"ts": round(time.time(), 3), "event": event, **data}
        try:
            # allow_nan=False turns a NaN into the ValueError that routes the
            # record through _jsonable
            line = json.dumps(record, allow_nan=False)
        except (TypeError, ValueError):
            line = json.dumps({"ts": record["ts"], "event": event, **{k: _jsonable(v) for k, v in data.items()}})
        with self._lock:
            if self._fh is None:
                return
            try:
                self._fh.write(line + "\n")
                now = time.monotonic()
                if event in _LAZY_FLUSH_EVENTS and now - self._last_flush < _LAZY_FLUSH_S:
                    return
                self._fh.flush()
                self._last_flush = now
            except (OSError, ValueError):
                pass  # a full disk or a closed file must not stop the run

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
