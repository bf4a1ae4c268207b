"""Request spans and on-demand profiling (the port of
sheeprl_tpu/telemetry/trace.py, the parts a serving process uses).

  1. **Spans.** A span is one telemetry event (``"event": "span"``) with a
     compact random id, an optional parent id and wall-clock ``t0``/``t1``.
     Parent ids cross processes in frame meta: a client puts its span id
     in a REQUEST's meta, the server's request span takes it as its parent
     and echoes its own id in the RESPONSE meta. `Tracer` is the emitter of
     one `Telemetry`.

  2. **Run ids.** `ensure_run_id` mints one id a run and exports it through
     ``SHEEPRL_TPU_TRACE_RUN``, so that processes started from it share it.

  3. **On-demand profiling.** `ProfileWindow` opens a bounded
     `torch.profiler` window on a live process, triggered by a PROFILE frame
     (`flock/wire.py` kind 17, answered by the serve server) or by SIGUSR2
     (`install_profile_signal`). It records CUDA activity when the process
     has the card, synchronizes the device before it stops (so that the
     trace holds every kernel launched before the stop), writes a chrome
     trace into ``<dir>/window_<ms>/trace.json`` and leaves
     ``profile.window.start`` / ``profile.window.stop`` events.

Kill switch: ``SHEEPRL_TPU_TRACE=0`` turns span emission off (the wire
fields stay absent). The reference's `ClockSync` (an offset estimate on the
flock's HEARTBEAT exchange) waits for the flock (ROADMAP Queue A item 9).
"""

from __future__ import annotations

import os
import random
import secrets
import signal
import tempfile
import threading
import time
from typing import Any

__all__ = [
    "PROFILE_DEFAULT_S",
    "PROFILE_MAX_S",
    "ProfileWindow",
    "RUN_ENV",
    "Span",
    "TRACE_ENV",
    "TRACE_FILE",
    "Tracer",
    "ensure_run_id",
    "handle_profile_frame",
    "install_profile_signal",
    "new_run_id",
    "new_span_id",
    "profile_window",
    "trace_enabled",
]

TRACE_ENV = "SHEEPRL_TPU_TRACE"
RUN_ENV = "SHEEPRL_TPU_TRACE_RUN"

PROFILE_DEFAULT_S = 3.0
PROFILE_MAX_S = 60.0
TRACE_FILE = "trace.json"  # the chrome trace inside a window's directory


def trace_enabled() -> bool:
    return os.environ.get(TRACE_ENV, "1") != "0"


def new_run_id() -> str:
    return secrets.token_hex(4)


def ensure_run_id() -> str:
    """The run id every process of one run shares: the first caller mints
    it and exports it through the environment; children inherit it."""
    rid = os.environ.get(RUN_ENV)
    if not rid:
        rid = new_run_id()
        os.environ[RUN_ENV] = rid
    return rid


# a private Random seeded from the OS: cheaper than secrets a span, and
# immune to a caller seeding the global `random` the same in every process
_span_rng = random.Random(secrets.randbits(64))


def new_span_id() -> str:
    """An 8-hex-character span id, small enough to ride every frame's meta."""
    return f"{_span_rng.getrandbits(32):08x}"


class Span:
    """One open span: `Tracer.begin` hands it out, `Tracer.end` emits it."""

    __slots__ = ("id", "name", "parent", "t0", "attrs")

    def __init__(self, sid: str, name: str, parent: str | None, t0: float):
        self.id = sid
        self.name = name
        self.parent = parent
        self.t0 = t0
        self.attrs: dict[str, Any] = {}


class Tracer:
    """Span emitter bound to one Telemetry. Every method is a no-op when
    tracing is off (the kill switch, read once here) or the Telemetry is
    closed, and tolerates a None span, so call sites never branch:

        span = tracer.begin("request", parent=client_span)
        ...
        tracer.end(span, outcome="served")   # safe if span is None
    """

    def __init__(self, telem: Any):
        self._telem = telem
        self._env_on = trace_enabled()

    @property
    def enabled(self) -> bool:
        return self._env_on and bool(getattr(self._telem, "enabled", False))

    def begin(self, name: str, parent: str | None = None, **attrs: Any) -> Span | None:
        if not self.enabled:
            return None
        span = Span(new_span_id(), name, parent, time.time())
        span.attrs.update(attrs)
        return span

    def end(self, span: Span | None, **attrs: Any) -> str | None:
        if span is None or not self.enabled:
            return None
        span.attrs.update(attrs)
        t1 = time.time()
        self._telem.event(
            "span", name=span.name, span=span.id, parent=span.parent, t0=round(span.t0, 6), t1=round(t1, 6),
            dur_ms=round((t1 - span.t0) * 1000.0, 3), **span.attrs,
        )
        return span.id


# ---------------------------------------------------------------------------
# on-demand profiling
# ---------------------------------------------------------------------------


def _profiler_active() -> bool:
    """Whether a torch.profiler session already runs in this process (on
    any thread): a second one cannot start beside it."""
    import torch.autograd.profiler as autograd_profiler

    return bool(getattr(autograd_profiler, "_is_profiler_enabled", False))


class ProfileWindow:
    """A bounded `torch.profiler` window that any live process can open on
    demand (PROFILE frame or SIGUSR2). One window at a time: a request that
    overlaps an open window, or that comes while another profiler runs in
    the process, is refused with `ok: false` and never touches the running
    one.

    A window runs on a thread of its own, which starts the profiler, waits
    out the window's seconds (or `close()`), synchronizes the device and
    stops it: torch's profiler must stop on the thread that started it.
    Its CUDA activity is process-wide, so the trace holds the kernels every
    thread launched (the serve dispatch thread's replays); its CPU events
    are only the window thread's own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._dir: str | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def active(self) -> bool:
        with self._lock:
            return self._dir is not None

    def request(self, out_dir: str, seconds: float = PROFILE_DEFAULT_S) -> dict:
        """Open a window into a fresh `out_dir/window_<ms>`, closed after
        `seconds` (clamped to [0.01, 60]). Returns ``{ok, dir, trace,
        seconds, pid, cuda}`` once the profiler runs, or ``{ok: False,
        error, ...}``."""
        seconds = min(max(float(seconds), 0.01), PROFILE_MAX_S)
        with self._lock:
            if self._dir is not None:
                return {"ok": False, "error": "profile window already open", "dir": self._dir, "pid": os.getpid()}
            if _profiler_active():
                return {"ok": False, "error": "another profiler is active in this process", "pid": os.getpid()}
            path = os.path.join(out_dir, f"window_{int(time.time() * 1000)}")
            started: dict = {}
            ready = threading.Event()
            self._stop = threading.Event()
            thread = threading.Thread(target=self._run, args=(path, seconds, self._stop, started, ready),
                                      name="profile-window", daemon=True)
            thread.start()
            ready.wait()
            if "error" in started:
                thread.join()
                return {"ok": False, "error": started["error"], "pid": os.getpid()}
            self._dir, self._thread = path, thread
        from .core import emit

        emit("profile.window.start", dir=path, seconds=seconds, pid=os.getpid(), cuda=started["cuda"])
        return {"ok": True, "dir": path, "trace": os.path.join(path, TRACE_FILE), "seconds": seconds,
                "pid": os.getpid(), "cuda": started["cuda"]}

    def _run(self, path: str, seconds: float, stop: threading.Event, started: dict, ready: threading.Event):
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            os.makedirs(path, exist_ok=True)
            prof = profile(activities=activities)
            prof.__enter__()
        except Exception as err:
            started["error"] = f"{type(err).__name__}: {err}"[:300]
            ready.set()
            return
        started["cuda"] = cuda
        ready.set()
        stop.wait(seconds)
        error = None
        try:
            if cuda:
                # every kernel launched before the stop lands in the trace
                torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(path, TRACE_FILE))
        except Exception as err:  # the stop event below carries it
            error = f"{type(err).__name__}: {err}"[:300]
        finally:
            with self._lock:
                if self._dir == path:
                    self._dir, self._thread = None, None
            from .core import emit

            emit("profile.window.stop", dir=path, pid=os.getpid(), error=error)

    def close(self, timeout: float | None = 60.0) -> None:
        """Stop the open window now and wait for its trace (a no-op when no
        window is open)."""
        with self._lock:
            thread = self._thread
            self._stop.set()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout)


_window = ProfileWindow()


def profile_window() -> ProfileWindow:
    """This process's one on-demand window: the frame and the signal
    triggers share its one-window-at-a-time rule."""
    return _window


def handle_profile_frame(req: dict, default_dir: str | None = None) -> dict:
    """Answer one PROFILE frame, ``{seconds?, dir?}``, with the
    `ProfileWindow.request` reply; the window goes under `dir`, else under
    `<default_dir>/profile_ondemand`."""
    out_dir = req.get("dir") or os.path.join(default_dir or tempfile.mkdtemp(prefix="sheepscope-"),
                                             "profile_ondemand")
    return _window.request(out_dir, req.get("seconds") or PROFILE_DEFAULT_S)


def install_profile_signal(log_dir: str, seconds: float = PROFILE_DEFAULT_S) -> bool:
    """SIGUSR2 -> a bounded window into `<log_dir>/profile_ondemand`. Only
    the main thread may install a handler: returns False elsewhere, and
    where the platform has no SIGUSR2."""
    if threading.current_thread() is not threading.main_thread():
        return False

    def _on_sigusr2(_signum, _frame):
        reply = _window.request(os.path.join(log_dir, "profile_ondemand"), seconds)
        if not reply.get("ok"):
            # the signal has no channel to carry the refusal back
            from .core import emit

            emit("profile.window.error", trigger="sigusr2", **reply)

    try:
        signal.signal(signal.SIGUSR2, _on_sigusr2)
    except (ValueError, OSError, AttributeError):
        return False
    return True
