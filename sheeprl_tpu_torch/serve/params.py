"""Double-buffered, hot-reloadable params store.

The dispatch path reads `current()` — a single attribute load of an
immutable `(version, params)` tuple, so a reader sees the old snapshot or
the new one, never a torn mix. A reload builds version N+1 completely OFF
the dispatch path (a checkpoint restore can take seconds) and then flips the tuple
atomically between dispatches; in-flight dispatches keep the reference
they already grabbed, so no request ever observes a half-swapped model.

Failure semantics: a reload that raises keeps serving version N and only
increments `Serve/reload_failures` — a corrupt checkpoint degrades the
freshness of the policy, never its availability.

`GraphParams` keeps, per kind of params (f32, int8), the object the rungs'
CUDA graphs were captured with: a graph reads its parameters by address,
so before a dispatch of a newer version the dispatch thread copies that
version's tensors into the held object's, on its own stream, ahead of the
replay. A dispatch still sees one whole version, never a mix of two.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

import torch

__all__ = ["GraphParams", "ParamsStore"]


class ParamsStore:
    def __init__(
        self,
        loader: Callable[[str], Any],
        params: Any,
        source: str | None = None,
        telem: Any = None,
        reload_lock: Any = None,
    ):
        self._loader = loader
        self._slot: tuple[int, Any] = (1, params)  # the atomic flip point
        self._source = source
        self._telem = telem
        # one reload at a time; never held on the dispatch path. A caller's
        # lock keeps reloads apart from its own work on the card too (serve's
        # retier probes and captures)
        self._reload_lock = reload_lock if reload_lock is not None else threading.Lock()
        # called after a successful flip with (version, params), still in
        # the reload thread: derived state (the quantized twin) rebuilds
        # here instead of stalling the first dispatch that needs it
        self.on_reload: Callable[[int, Any], Any] | None = None
        self.reloads = 0
        self.reload_failures = 0
        self.last_reload_seconds = 0.0
        self.last_error: str | None = None

    @property
    def version(self) -> int:
        return self._slot[0]

    @property
    def source(self) -> str | None:
        """The checkpoint the current version was loaded from."""
        return self._source

    def current(self) -> tuple[int, Any]:
        """Lock-free snapshot read: (version, params)."""
        return self._slot

    def reload(self, path: str | None = None) -> dict[str, Any]:
        """Load `path` (default: the current source) off-path and flip.
        Returns {ok, version, seconds, error} — the RELOAD reply payload."""
        target = path or self._source
        if not target:
            return {
                "ok": False, "version": self.version, "seconds": 0.0,
                "error": "no checkpoint path to reload (fresh-init server)",
            }
        with self._reload_lock:
            t0 = time.perf_counter()
            try:
                fresh = self._loader(target)
            except Exception as err:
                seconds = time.perf_counter() - t0
                self.reload_failures += 1
                self.last_error = f"{type(err).__name__}: {err}"[:300]
                self._event(
                    "serve.reload", ok=False, version=self.version,
                    path=target, seconds=round(seconds, 3), error=self.last_error,
                )
                return {
                    "ok": False, "version": self.version,
                    "seconds": seconds, "error": self.last_error,
                }
            version = self._slot[0] + 1
            self._slot = (version, fresh)  # the atomic flip
            self._source = target
            seconds = time.perf_counter() - t0
            self.reloads += 1
            self.last_reload_seconds = seconds
            self.last_error = None
            self._event(
                "serve.reload", ok=True, version=version, path=target,
                seconds=round(seconds, 3), error=None,
            )
            if self.on_reload is not None:
                try:
                    self.on_reload(version, fresh)
                except Exception as err:
                    # the swap itself succeeded; a broken derived-state hook
                    # degrades to the lazy (first-dispatch) rebuild
                    self._event(
                        "serve.reload_hook_error", version=version,
                        error=f"{type(err).__name__}: {err}"[:300],
                    )
            return {"ok": True, "version": version, "seconds": seconds, "error": None}

    def gauges(self) -> dict[str, float]:
        return {
            "Serve/params_version": float(self.version),
            "Serve/reloads": float(self.reloads),
            "Serve/reload_failures": float(self.reload_failures),
            "Serve/last_reload_seconds": self.last_reload_seconds,
        }

    def _event(self, name: str, **data: Any) -> None:
        if self._telem is not None:
            try:
                self._telem.event(name, **data)
            # sheeplint: disable=SL012 — the event sink is the thing that
            # failed; reload availability must not depend on telemetry
            except Exception:
                pass


class GraphParams:
    """The params object each kind of rung ("f32", "int8") is captured with,
    and the version its tensors hold. Only the dispatch thread calls `sync`."""

    def __init__(self):
        self._held: dict[str, list] = {}  # kind -> [version, params]

    def sync(self, kind: str, version: int, params: Any) -> Any:
        """The held object of `kind`, holding `version`'s tensors: the first
        object seen is kept; a newer version's state is copied into it."""
        slot = self._held.get(kind)
        if slot is None:
            self._held[kind] = [version, params]
            return params
        if slot[0] != version:
            src = params.state_dict()
            with torch.no_grad():
                for k, dst in slot[1].state_dict().items():
                    dst.copy_(src[k])
            slot[0] = version
        return slot[1]
