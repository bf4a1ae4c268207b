"""Micro-batcher: accumulate concurrent requests, pad to a ladder rung,
dispatch one fixed-shape call, slice per-request results back out.

Policy:

  - a request is a str-keyed dict of numpy arrays with a leading rows
    axis; rows, not requests, fill a rung;
  - dispatch fires when the oldest queued request has waited
    `window_ms` OR the queue already fills the largest rung — whichever
    comes first;
  - the dispatch batch is padded with zero rows up to the smallest
    accepted rung that fits (fixed shapes per rung), and the
    results are sliced back per request in submit order. Per-row math is
    row-independent, so padding never changes a served row;
  - a request still queued past its deadline is SHED before dispatch
    (typed `RequestShed` with a retry_after hint) — load past capacity
    degrades into fast rejections, not queue collapse;
  - a request with more rows than the largest rung can never be served
    and is rejected at submit with a typed `OversizedRequest`.

The batcher is transport- and device-free (numpy in, numpy out; the dispatch
callable owns device work), so the edge cases are unit-testable with an
injected clock and no server.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from .errors import OversizedRequest, RequestShed, ServeError

__all__ = ["MicroBatcher", "PendingRequest"]


class PendingRequest:
    """One submitted request: completed by the dispatch loop with either a
    result tree or a typed error."""

    __slots__ = (
        "obs", "meta", "rows", "enqueue_t", "deadline_t",
        "done", "result", "error", "rung", "version", "queue_ms",
    )

    def __init__(self, obs, meta, rows, enqueue_t, deadline_t):
        self.obs = obs
        self.meta = meta
        self.rows = rows
        self.enqueue_t = enqueue_t
        self.deadline_t = deadline_t
        self.done = threading.Event()
        self.result: dict[str, np.ndarray] | None = None
        self.error: Exception | None = None
        self.rung = 0
        self.version = 0
        self.queue_ms = 0.0

    def wait(self, timeout: float | None = None) -> dict[str, np.ndarray]:
        """Block until served; raises the typed error on shed/failure."""
        if not self.done.wait(timeout):
            raise ServeError("request timed out awaiting dispatch")
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result

    def _complete(self, result=None, error=None) -> None:
        self.result = result
        self.error = error
        self.done.set()


class MicroBatcher:
    def __init__(
        self,
        dispatch: Callable[[dict, list, int], tuple[dict, int]],
        rungs: list[int],
        window_ms: float = 2.0,
        default_deadline_ms: float = 100.0,
        clock: Callable[[], float] = time.monotonic,
        telem: Any = None,
    ):
        if not rungs:
            raise ValueError("MicroBatcher needs at least one ladder rung")
        self._dispatch = dispatch
        self.rungs = sorted(rungs)
        self.max_rung = self.rungs[-1]
        self.window_s = max(window_ms, 0.0) / 1000.0
        self.default_deadline_s = (
            default_deadline_ms / 1000.0 if default_deadline_ms > 0 else None
        )
        self._clock = clock
        self._telem = telem
        self._queue: deque[PendingRequest] = deque()
        self._cond = threading.Condition()
        self._thread: threading.Thread | None = None
        self._closed = False
        # counters (read by gauges; written under _cond or by the single
        # dispatch thread)
        self.submitted = 0
        self.served = 0
        self.shed = 0
        self.oversized = 0
        self.failed = 0
        self.dispatches = 0
        self.rows_served = 0
        self.last_dispatch_ms = 0.0
        self._occupancy = deque(maxlen=256)  # rows/rung per dispatch

    # ---- client side -------------------------------------------------------
    def submit(
        self,
        obs: dict[str, np.ndarray],
        meta: dict | None = None,
        deadline_ms: float | None = None,
    ) -> PendingRequest:
        rows = _rows_of(obs)
        if rows < 1:
            raise ServeError("request carries zero rows")
        if rows > self.max_rung:
            with self._cond:
                self.oversized += 1
            raise OversizedRequest(rows, self.max_rung)
        now = self._clock()
        if deadline_ms is None:
            deadline_t = (
                None if self.default_deadline_s is None
                else now + self.default_deadline_s
            )
        else:
            deadline_t = now + deadline_ms / 1000.0 if deadline_ms > 0 else None
        pending = PendingRequest(obs, meta or {}, rows, now, deadline_t)
        with self._cond:
            if self._closed:
                raise ServeError("batcher is closed")
            self.submitted += 1
            self._queue.append(pending)
            self._cond.notify_all()
        return pending

    # ---- dispatch side -----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        """Stop the loop, draining the queue first — in-flight requests are
        served, never dropped (the hot-reload zero-drop guarantee extends
        to shutdown)."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        while self.flush_once():  # drain whatever the loop left behind
            pass

    def _loop(self) -> None:
        while True:
            with self._cond:
                # SY005: both waits re-check their predicate in the while
                # head — spurious wakeups and stale notifies are harmless
                while not self._queue and not self._closed:
                    self._cond.wait(0.05)
                if self._closed:
                    break
                # batch window: wait for more rows after the first request,
                # but never past the oldest request's window
                window_end = self._queue[0].enqueue_t + self.window_s
                while (
                    not self._closed
                    and sum(p.rows for p in self._queue) < self.max_rung
                    and self._clock() < window_end
                ):
                    self._cond.wait(max(window_end - self._clock(), 0.0005))
            self.flush_once()
        while self.flush_once():  # closed: drain
            pass

    def flush_once(self, now: float | None = None) -> int:
        """One dispatch cycle: shed expired requests, assemble up to one
        rung of rows, dispatch, slice results. Returns the number of
        requests completed (served + shed + failed); 0 on an empty window
        flush — waking with nothing queued dispatches nothing. Unit tests
        drive this directly with an injected clock."""
        if now is None:
            now = self._clock()
        batch: list[PendingRequest] = []
        expired: list[PendingRequest] = []
        rows = 0
        with self._cond:
            keep: deque[PendingRequest] = deque()
            for p in self._queue:
                if p.deadline_t is not None and now >= p.deadline_t:
                    expired.append(p)
                elif rows + p.rows <= self.max_rung:
                    batch.append(p)
                    rows += p.rows
                else:
                    keep.append(p)
            self._queue = keep
            self.shed += len(expired)
        retry_ms = self.retry_after_ms()
        for p in expired:  # shed BEFORE dispatch: no compute spent on them
            p._complete(error=RequestShed(retry_ms))
            self._event(
                "serve.shed", reason="deadline",
                queued_ms=round((now - p.enqueue_t) * 1000.0, 2),
                retry_after_ms=round(retry_ms, 1),
            )
        if not batch:
            return len(expired)
        rung = next(r for r in self.rungs if r >= rows)
        stacked = _stack_pad([p.obs for p in batch], rows, rung)
        t0 = self._clock()
        try:
            out, version = self._dispatch(stacked, batch, rung)
        except Exception as err:
            with self._cond:
                self.failed += len(batch)
            failure = err if isinstance(err, ServeError) else ServeError(
                f"dispatch failed: {type(err).__name__}: {err}"
            )
            for p in batch:
                p._complete(error=failure)
            return len(expired) + len(batch)
        dispatch_ms = (self._clock() - t0) * 1000.0
        off = 0
        for p in batch:
            p.rung = rung
            p.version = version
            p.queue_ms = (t0 - p.enqueue_t) * 1000.0
            p._complete(result={k: v[off : off + p.rows] for k, v in out.items()})
            off += p.rows
        with self._cond:
            self.served += len(batch)
            self.rows_served += rows
            self.dispatches += 1
            self.last_dispatch_ms = dispatch_ms
            self._occupancy.append(rows / rung)
        return len(expired) + len(batch)

    # ---- observability -----------------------------------------------------
    def retry_after_ms(self) -> float:
        """SHED retry hint: one batch window plus the cost of the dispatch
        currently ahead of a retry."""
        return self.window_s * 1000.0 + self.last_dispatch_ms

    def queue_depth(self) -> int:
        with self._cond:
            return sum(p.rows for p in self._queue)

    def gauges(self) -> dict[str, float]:
        with self._cond:
            occ = (
                sum(self._occupancy) / len(self._occupancy)
                if self._occupancy else 0.0
            )
            return {
                "Serve/requests_total": float(self.submitted),
                "Serve/served_total": float(self.served),
                "Serve/shed_total": float(self.shed),
                "Serve/oversized_total": float(self.oversized),
                "Serve/failed_total": float(self.failed),
                "Serve/dispatches": float(self.dispatches),
                "Serve/rows_served": float(self.rows_served),
                "Serve/queue_depth": float(sum(p.rows for p in self._queue)),
                "Serve/batch_occupancy": occ,
                "Serve/last_dispatch_ms": self.last_dispatch_ms,
                "Serve/rungs": float(len(self.rungs)),
            }

    def _event(self, name: str, **data: Any) -> None:
        if self._telem is not None:
            try:
                self._telem.event(name, **data)
            # sheeplint: disable=SL012 — the event sink is the thing that
            # failed; shedding must stay cheap
            except Exception:
                pass


def _rows_of(obs: dict[str, np.ndarray]) -> int:
    rows = {int(np.shape(v)[0]) for v in obs.values()} if obs else set()
    if len(rows) != 1:
        raise ServeError(
            f"request leaves disagree on the rows axis: {sorted(rows)}"
        )
    return rows.pop()


def _stack_pad(
    trees: list[dict[str, np.ndarray]], rows: int, rung: int
) -> dict[str, np.ndarray]:
    """Concatenate per-request rows and zero-pad up to the rung. Zero rows
    are inert: per-row policy math never mixes rows, and the pad slice is
    discarded before results leave the batcher."""
    keys = trees[0].keys()
    out = {}
    for k in keys:
        parts = [np.asarray(t[k]) for t in trees]
        cat = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        if rung > rows:
            pad = np.zeros((rung - rows,) + cat.shape[1:], dtype=cat.dtype)
            cat = np.concatenate([cat, pad], axis=0)
        out[k] = cat
    return out
