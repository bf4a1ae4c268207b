"""Thin blocking client for the serving tier (the port of
sheeprl_tpu/serve/client.py).

One socket, one in-flight request at a time (concurrency = many clients).
Typed failures: a SHED frame raises `RequestShed` (read `.retry_after_ms`
and come back), an ERROR frame raises `OversizedRequest` or `ServeError`,
a dead socket raises `ConnectionLost`.

    client = ServeClient("unix:/tmp/.../serve.sock")
    result, meta = client.request({"rgb": obs[None]}, session="s0")
    actions = result["actions"]
    client.close()

`request(..., retries=N)` absorbs up to N failures: a SHED reply sleeps the
server's `retry_after_ms` hint before resending; a dead socket reconnects
and resends the SAME request id, which the server answers from its dedupe
map if it already executed it.

With tracing on (`telemetry/trace.py`; SHEEPRL_TPU_TRACE=0 turns it off)
each REQUEST's meta carries a fresh span id; the server's request span
takes it as its parent and the RESPONSE meta carries the server's own.
`profile(seconds)` asks the server for an on-demand profiler window.
"""

from __future__ import annotations

import itertools
import json
import secrets
import time
from typing import Any

import numpy as np

from ..flock import wire
from ..telemetry import trace as tracelib
from .errors import ConnectionLost, OversizedRequest, RequestShed, ServeError
from .server import HEALTH, PROTO_VERSION, pack_request, unpack_request

__all__ = ["ServeClient"]


class ServeClient:
    def __init__(self, address: str, timeout: float | None = 60.0, retries: int = 0,
                 backoff_s: float = 0.1):
        self._address = address
        self._timeout = timeout
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        # idempotent request ids: random per-client nonce + counter
        self._nonce = secrets.token_hex(4)
        self._ids = itertools.count(1)
        self._sock: Any = None
        self._connect()

    def _connect(self) -> None:
        self._sock = wire.connect(self._address, timeout=self._timeout)
        wire.send_json(self._sock, wire.HELLO, {"proto": PROTO_VERSION})
        self.info = wire.recv_json(self._sock, wire.WELCOME)

    def _drop_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass  # the socket is being discarded either way
            self._sock = None

    def request(
        self,
        obs: dict[str, np.ndarray],
        deadline_ms: float | None = None,
        session: str | None = None,
        reset: bool = False,
        retries: int | None = None,
    ) -> tuple[dict[str, np.ndarray], dict]:
        """-> (result tree, response meta). Raises RequestShed past the
        deadline, OversizedRequest for rows beyond the ladder, ServeError for
        dispatch failures, ConnectionLost for a dead socket."""
        budget = self._retries if retries is None else int(retries)
        meta: dict[str, Any] = {"id": f"{self._nonce}-{next(self._ids)}"}
        if tracelib.trace_enabled():
            meta["span"] = tracelib.new_span_id()
        if deadline_ms is not None:
            meta["deadline_ms"] = deadline_ms
        if session is not None:
            meta["session"] = session
        if reset:
            meta["reset"] = True
        payload = pack_request(meta, obs)
        attempt = 0
        while True:
            try:
                return self._request_once(payload)
            except RequestShed as shed:
                if attempt >= budget:
                    raise
                time.sleep(max(shed.retry_after_ms, 0.0) / 1000.0)
            except ConnectionLost:
                if attempt >= budget:
                    raise
                time.sleep(self._backoff_s * (2.0**attempt))
                try:
                    self._drop_socket()
                    self._connect()
                except (OSError, TimeoutError) as err:
                    if attempt + 1 >= budget:
                        raise ConnectionLost(f"reconnect to {self._address!r} failed: {err}") from err
            attempt += 1

    def _request_once(self, payload: bytes) -> tuple[dict[str, np.ndarray], dict]:
        try:
            wire.send_frame(self._sock, wire.REQUEST, payload)
            frame = wire.recv_frame(self._sock)
        except (OSError, TimeoutError) as err:
            self._drop_socket()
            raise ConnectionLost(f"server connection died mid-request: {err}") from err
        if frame is None:
            self._drop_socket()
            raise ConnectionLost("server closed the connection")
        kind, reply = frame
        if kind == wire.RESPONSE:
            resp_meta, result = unpack_request(reply)
            return result, resp_meta
        if kind == wire.SHED:
            shed = json.loads(reply.decode())
            raise RequestShed(float(shed.get("retry_after_ms", 0.0)), shed.get("reason", "deadline"))
        if kind == wire.ERROR:
            err = json.loads(reply.decode())
            if err.get("kind") == "oversized":
                raise OversizedRequest(-1, -1, message=err.get("error"))
            raise ServeError(err.get("error", "request failed"))
        raise wire.FrameError(f"unexpected reply kind {wire.KIND_NAMES.get(kind, kind)}")

    def health(self) -> dict:
        """HEALTH round-trip: {ready, draining, version, queue_depth, completed}."""
        try:
            wire.send_json(self._sock, HEALTH, {})
            return wire.recv_json(self._sock, HEALTH)
        except (OSError, TimeoutError) as err:
            self._drop_socket()
            raise ConnectionLost(f"health probe failed: {err}") from err

    def profile(self, seconds: float | None = None, out_dir: str | None = None) -> dict:
        """PROFILE round-trip: a bounded profiler window in the server
        process -> {ok, dir, trace, seconds, pid} or {ok: False, error}."""
        req: dict[str, Any] = {}
        if seconds is not None:
            req["seconds"] = seconds
        if out_dir is not None:
            req["dir"] = out_dir
        wire.send_json(self._sock, wire.PROFILE, req)
        return wire.recv_json(self._sock, wire.PROFILE)

    def reload(self, path: str | None = None) -> dict:
        """Ask the server to hot-reload; returns its {ok, version, seconds, error}."""
        wire.send_json(self._sock, wire.RELOAD, {"path": path})
        return wire.recv_json(self._sock, wire.RELOAD)

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            wire.send_frame(self._sock, wire.BYE)
        except OSError:
            pass  # a dead socket at close is expected after a server exit
        self._drop_socket()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
