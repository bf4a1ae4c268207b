"""Typed serving errors. The server maps these onto wire frames: a
`RequestShed` becomes a SHED frame (retryable, carries the retry hint), an
`OversizedRequest` becomes an ERROR frame (the client must split the
request — retrying the same payload can never succeed), anything else
becomes a generic ERROR frame. `ConnectionLost` is client-side only: the
socket died mid-request — safe to reconnect and resend the SAME request
id (the server dedupes)."""

from __future__ import annotations

__all__ = ["ConnectionLost", "OversizedRequest", "RequestShed", "ServeError"]


class ServeError(RuntimeError):
    """Base class for serving-tier failures."""


class ConnectionLost(ServeError):
    """The server connection died mid-request (crash, restart, injected
    partition). Retryable: request ids are idempotent, so reconnecting and
    resending the same id can never double-execute."""


class OversizedRequest(ServeError):
    """A single request carries more rows than the largest batch rung — it
    can never be dispatched, shed or not. Rejected at submit time."""

    def __init__(self, rows: int, max_rung: int, message: str | None = None):
        super().__init__(
            message
            or f"request carries {rows} rows but the largest batch rung is "
            f"{max_rung}; split the request"
        )
        self.rows = rows
        self.max_rung = max_rung


class RequestShed(ServeError):
    """Deadline-aware load shed: the request expired before dispatch (or
    the queue is past its depth bound). NOT a failure of the request
    itself — retry after `retry_after_ms`."""

    def __init__(self, retry_after_ms: float, reason: str = "deadline"):
        super().__init__(f"request shed ({reason}); retry after {retry_after_ms:.0f} ms")
        self.retry_after_ms = float(retry_after_ms)
        self.reason = reason
