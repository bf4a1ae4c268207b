"""Socket front of the serving tier (the port of sheeprl_tpu/serve/server.py,
without its span tracing and on-demand profiling): FLK1 frames in,
micro-batched dispatch in the middle, FLK1 frames out.

One accept thread plus one handler thread per client connection. A handler
parses REQUEST frames, submits to the shared MicroBatcher, blocks on the
per-request event, and answers with exactly one frame per request:

    RESPONSE  served — u32 meta_len | meta_json | pack_tree result blob,
              meta {id, version, rung, rows, queue_ms}
    SHED      deadline passed while queued — {id, retry_after_ms, reason}
    ERROR     typed rejection (oversized request, dispatch failure) —
              {id, error, kind}

RELOAD frames trigger `ParamsStore.reload` in the handler thread. HELLO /
WELCOME carries the serving contract: algo, ladder rungs, params version.
HEALTH frames (kind 16) answer {ready, draining, version, queue_depth,
completed}.

String request ids are idempotent: a terminal answer (RESPONSE/ERROR, never
SHED) is cached in a bounded dedupe map, so a client that reconnects and
replays an executed id gets the cached answer instead of a second
execution. `drain()` flips the server into graceful shutdown: queued work
finishes, NEW requests are shed with reason="draining".

The server owns the client-visible latency clock: per-response wall time
from frame-in to frame-out feeds the `Serve/qps`, `Serve/latency_p50_ms`
and `Serve/latency_p99_ms` gauges.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import tempfile
import threading
import time
from collections import OrderedDict, deque
from typing import Any

import numpy as np

from ..data.wire import pack_tree, unpack_tree
from ..flock import wire
from .errors import OversizedRequest, RequestShed, ServeError

__all__ = ["ServeServer", "pack_request", "unpack_request"]

_U32 = struct.Struct("<I")

PROTO_VERSION = 1

HEALTH = wire.register_kind(16, "health")

DEDUPE_CAP = 256  # replayed-id answers kept per server


def pack_request(meta: dict, obs: dict[str, np.ndarray]) -> bytes:
    """REQUEST/RESPONSE payload: u32 meta_len | meta_json | pack_tree blob."""
    mb = json.dumps(meta).encode()
    return b"".join([_U32.pack(len(mb)), mb, pack_tree(obs)])


def unpack_request(payload: bytes) -> tuple[dict, dict[str, np.ndarray]]:
    (meta_len,) = _U32.unpack_from(payload, 0)
    meta = json.loads(payload[4 : 4 + meta_len].decode())
    return meta, unpack_tree(payload[4 + meta_len :])


class ServeServer:
    def __init__(self, policy: Any, store: Any, batcher: Any, bind: str = "unix:auto",
                 telem: Any = None):
        self.policy = policy
        self.store = store
        self.batcher = batcher
        self._bind = bind
        self._telem = telem
        self.address: str | None = None
        self._listener: socket.socket | None = None
        self._unix_path: str | None = None
        self._conns: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._lock = threading.Lock()
        # (done_t, total_ms) per completed request — the QPS/percentile source
        self._latencies: deque[tuple[float, float]] = deque(maxlen=4096)
        self.completed = 0  # responses + sheds + errors actually answered
        self._dedupe: OrderedDict[str, tuple[int, bytes]] = OrderedDict()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> str:
        kind, *parts = wire.parse_address(self._resolve_bind(self._bind))
        if kind == "tcp":
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((parts[0], int(parts[1])))
            self.address = wire.format_address("tcp", parts[0], srv.getsockname()[1])
        else:
            self._unix_path = parts[0]
            srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            srv.bind(self._unix_path)
            self.address = wire.format_address("unix", self._unix_path)
        srv.listen(64)
        self._listener = srv
        self.batcher.start()
        t = threading.Thread(target=self._accept_loop, name="serve-accept", daemon=True)
        t.start()
        self._threads.append(t)
        self._event("serve.listening", address=self.address, algo=self.policy.algo)
        return self.address

    @staticmethod
    def _resolve_bind(bind: str) -> str:
        if bind == "unix:auto":
            # short tempdir path: AF_UNIX paths cap at ~107 bytes
            sock_dir = tempfile.mkdtemp(prefix="sheepserve-")
            return wire.format_address("unix", os.path.join(sock_dir, "serve.sock"))
        return bind

    def drain(self) -> None:
        """Graceful shutdown half 1: stop ACCEPTING work (new requests are
        shed with reason="draining") while every queued request finishes.
        `close()` then tears the sockets down."""
        if self._draining.is_set():
            return
        self._draining.set()
        self._event("serve.draining", queue_depth=float(self.batcher.queue_depth()),
                    completed=self.completed)
        self.batcher.close()  # blocks until the queue is served
        self._event("serve.drained", completed=self.completed)

    def close(self) -> None:
        self._stop.set()
        for sock in [self._listener, *self._conns]:
            if sock is not None:
                # shutdown first: close() alone leaves a thread blocked in
                # accept()/recv() on that socket asleep
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass  # already disconnected
                try:
                    sock.close()
                except OSError:
                    pass
        # drain before exit: every queued request is answered, never dropped
        self.batcher.close()
        for t in self._threads:
            t.join(timeout=5.0)
        if self._unix_path:
            try:
                os.unlink(self._unix_path)
                os.rmdir(os.path.dirname(self._unix_path))
            except OSError:
                pass

    # -- socket side ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,), name="serve-conn", daemon=True)
            t.start()
            self._threads.append(t)

    def _hello_payload(self) -> dict:
        return {
            "proto": PROTO_VERSION,
            "algo": self.policy.algo,
            "rungs": list(self.batcher.rungs),
            "max_rows_per_request": self.policy.max_rows_per_request,
            "version": self.store.version,
        }

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            frame = wire.recv_frame(conn)
            if frame is None or frame[0] != wire.HELLO:
                return
            wire.send_json(conn, wire.WELCOME, self._hello_payload())
            while not self._stop.is_set():
                frame = wire.recv_frame(conn)
                if frame is None:
                    return
                kind, payload = frame
                if kind == wire.BYE:
                    return
                if kind == wire.RELOAD:
                    req = json.loads(payload.decode()) if payload else {}
                    wire.send_json(conn, wire.RELOAD, self.store.reload(req.get("path")))
                elif kind == HEALTH:
                    wire.send_json(conn, HEALTH, {
                        "ready": not self._draining.is_set(),
                        "draining": self._draining.is_set(),
                        "version": self.store.version,
                        "queue_depth": self.batcher.queue_depth(),
                        "completed": self.completed,
                    })
                elif kind == wire.REQUEST:
                    self._handle_request(conn, payload)
                else:
                    wire.send_json(conn, wire.ERROR,
                                   {"error": f"unexpected frame kind {kind}", "kind": "protocol"})
        except (wire.FrameError, ConnectionError, OSError, ValueError) as err:
            # the failure killed only THIS connection; every other client
            # keeps being served, and the event is its receipt
            if not self._stop.is_set():
                self._event("serve.conn_error", error=f"{type(err).__name__}: {err}")
        finally:
            try:
                conn.close()
            except OSError as err:
                self._event("serve.close_error", error=f"{type(err).__name__}: {err}")

    def _handle_request(self, conn: socket.socket, payload: bytes) -> None:
        t0 = time.monotonic()
        meta, obs = unpack_request(payload)
        rid = meta.get("id")
        if isinstance(rid, str):
            with self._lock:
                cached = self._dedupe.get(rid)
            if cached is not None:
                # replayed id after a reconnect: repeat the answer, not the work
                wire.send_frame(conn, cached[0], cached[1])
                return
        if self._draining.is_set():
            wire.send_json(conn, wire.SHED, {
                "id": rid, "retry_after_ms": round(self.batcher.retry_after_ms(), 1),
                "reason": "draining",
            })
            self._finish(t0)
            return
        limit = self.policy.max_rows_per_request
        try:
            if limit is not None:
                rows = {int(np.shape(v)[0]) for v in obs.values()}
                if rows and max(rows) > limit:
                    raise ServeError(
                        f"{self.policy.algo} requests are limited to {limit} row(s) per "
                        f"request (got {max(rows)}) — recurrent state is per-session"
                    )
            pending = self.batcher.submit(obs, meta=meta, deadline_ms=meta.get("deadline_ms"))
            result = pending.wait(timeout=60.0)
        except RequestShed as shed:
            # sheds are NOT cached for dedupe: "not executed, retry later"
            # must stay retryable under the same id
            wire.send_json(conn, wire.SHED, {
                "id": rid, "retry_after_ms": round(shed.retry_after_ms, 1), "reason": shed.reason,
            })
            self._finish(t0)
            return
        except OversizedRequest as err:
            self._answer(conn, rid, wire.ERROR,
                         json.dumps({"id": rid, "error": str(err), "kind": "oversized"}).encode())
            self._finish(t0)
            return
        except ServeError as err:
            self._answer(conn, rid, wire.ERROR,
                         json.dumps({"id": rid, "error": str(err), "kind": "failed"}).encode())
            self._finish(t0)
            return
        out_meta = {
            "id": rid,
            "version": pending.version,
            "rung": pending.rung,
            "rows": pending.rows,
            "queue_ms": round(pending.queue_ms, 3),
        }
        self._answer(conn, rid, wire.RESPONSE, pack_request(out_meta, result))
        self._finish(t0)

    def _answer(self, conn: socket.socket, rid, kind: int, payload: bytes) -> None:
        """Send a TERMINAL answer (RESPONSE/ERROR), remembering it for string
        (idempotent) ids so a replay never re-executes."""
        if isinstance(rid, str):
            with self._lock:
                self._dedupe[rid] = (kind, payload)
                while len(self._dedupe) > DEDUPE_CAP:
                    self._dedupe.popitem(last=False)
        wire.send_frame(conn, kind, payload)

    def _finish(self, t0: float) -> None:
        now = time.monotonic()
        with self._lock:
            self._latencies.append((now, (now - t0) * 1000.0))
            self.completed += 1

    # -- observability ---------------------------------------------------------

    def gauges(self) -> dict[str, float]:
        now = time.monotonic()
        with self._lock:
            lats = sorted(ms for _, ms in self._latencies)
            recent = sum(1 for t, _ in self._latencies if now - t <= 10.0)
        out = {
            "Serve/draining": float(self._draining.is_set()),
            "Serve/qps": recent / 10.0,
            "Serve/latency_p50_ms": _percentile(lats, 0.50),
            "Serve/latency_p99_ms": _percentile(lats, 0.99),
            "Serve/completed_total": float(self.completed),
        }
        out.update(self.batcher.gauges())
        out.update(self.store.gauges())
        return out

    def _event(self, name: str, **data: Any) -> None:
        if self._telem is not None:
            self._telem.event(name, **data)


def _percentile(sorted_ms: list[float], q: float) -> float:
    if not sorted_ms:
        return 0.0
    idx = min(int(q * len(sorted_ms)), len(sorted_ms) - 1)
    return sorted_ms[idx]
