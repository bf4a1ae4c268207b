"""CompilePlan: whole-step CUDA graphs (the port of sheeprl_tpu/compile/plan.py).

The reference never dispatches op by op: each hot step is one `jax.jit`
executable, and its `CompilePlan` registers those steps with example
arguments and builds them ahead of time. The port's executable is a
`torch.cuda.CUDAGraph`. Each algo main (and `serve`, per rung) registers
its hot step and calls the returned `WarmJit` in place of the step:

    plan = CompilePlan.from_args(args, telem)
    step = plan.register("train_step", step, example=lambda: (...), role="update")
    plan.start()          # --warm_compile on: capture every entry here
    ... the loop calls step(...) ...
    plan.close()

On CUDA an entry is built in three stages:

  1. **warm up**: the step runs eagerly on a side stream. This is where the
     kernels are built (nvcc), an optimizer's state is created and each
     kernel wrapper's `cudaFuncSetAttribute` first runs. With
     `--warm_compile off` (the algo default) this is the entry's first
     real call, and its result is the call's result. With `on` (the serve
     default) `start()` warms up on the example's arguments and then puts
     back the state it knows the warm-up may change (`_Untouched`): the
     modules' parameters and buffers, the optimizers' state (a state the
     warm-up created is reset as a fresh optimizer's: step counts and
     moments zeroed), objects with `state_dict`/`load_state_dict` (the
     return normaliser) through those, and the argument tensors;
  2. **capture** once, into static input tensors (copies of the call's) and
     the static outputs the capture returns; the garbage collector runs
     before it and not during it (a collection that destroyed a dead graph
     mid-capture would invalidate the capture);
  3. **call**: each later call `copy_`s its tensor arguments into the
     static inputs (none that already is one: `WarmJit.static_args`),
     replays the graph and returns the static outputs. The next replay
     overwrites them: a caller that keeps an output clones it.

A call's signature is its tree of tensors (shape, dtype, device) and of
every other argument (numbers and strings by value, anything else by
identity: a module, an optimizer). A call whose signature differs from the
capture's runs eagerly on the card, counts a `fallback` and writes a
`compile.fallback` event, as the reference's aval drift does
(`plan.py:236-256`). A Python float caught in a capture would replay its
first value forever, so the steps take their annealed and scheduled values
as device scalars. A capture that fails raises: there is no quiet eager
path when a graph cannot be built.

The kernel wrappers count their launches on the host, where they launch:
the eager calls and the capture (which records its launches into the
graph). A replay runs no Python and moves no counter; the plan only reads
the counters around a capture, so each entry's `launches_per_replay` says
what one replay launches. The launches a replay really runs are the
device's to count (`chip_smoke.py` counts them with torch.profiler).

On the CPU (`--device cpu`, every tier-1 test) a `WarmJit` calls its step
directly: CUDA graphs do not exist there and the caller asked for the CPU.
The tests drive the copy-in and copy-out machinery on the CPU with
`mode="static"`, where a "replay" runs the step on the static inputs and
copies its results into the static outputs.

Captures run on the calling thread, in `thread_local` capture mode, so a
reload thread's copies do not break a capture in the dispatch thread.
Not ported: the reference's background compile threads (a capture on a
second thread would take the loop's launches), `declare_edge` and
`SHEEPRL_TPU_PLAN_MODE=capture` (with `analysis/`), and the persistent
compile cache (a graph cannot be saved; `build/kernels/` caches the nvcc
builds).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable

import torch

__all__ = ["CompilePlan", "WarmJit", "graphed"]

_PLAIN = (int, float, bool, str, bytes, type(None), torch.dtype, torch.device)


# ---------------------------------------------------------------------------
# argument trees: tensors become static buffers, everything else is frozen
# ---------------------------------------------------------------------------


def _flatten(tree: Any, tensors: list) -> tuple:
    """The signature of `tree` (dicts, lists, tuples and dataclass
    instances of tensors and other values), appending its tensors to
    `tensors` in a fixed order (a dict's in the order of its sorted keys)."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
        return ("T", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):  # in key order, as jax's tree utilities
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_flatten(tree[k], tensors) for k in keys))
    if isinstance(tree, (list, tuple)) and type(tree) in (list, tuple):
        return (type(tree).__name__, tuple(_flatten(v, tensors) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        return ("dc", type(tree), names, tuple(_flatten(getattr(tree, n), tensors) for n in names))
    return ("S", tree)


def _same(a: tuple, b: tuple) -> bool:
    if a[0] != b[0]:
        return False
    if a[0] == "S":
        x, y = a[1], b[1]
        if x is y:
            return True
        return isinstance(x, _PLAIN) and type(x) is type(y) and x == y
    if a[0] == "T":
        return a == b
    if a[0] == "dict":
        return a[1] == b[1] and all(_same(x, y) for x, y in zip(a[2], b[2]))
    if a[0] == "dc":
        return a[1] is b[1] and a[2] == b[2] and all(_same(x, y) for x, y in zip(a[3], b[3]))
    return len(a[1]) == len(b[1]) and all(_same(x, y) for x, y in zip(a[1], b[1]))


def _build(spec: tuple, tensors) -> Any:
    """Rebuild a tree of `spec`'s shape from the iterator `tensors`."""
    kind = spec[0]
    if kind == "T":
        return next(tensors)
    if kind == "S":
        return spec[1]
    if kind == "dict":
        return {k: _build(s, tensors) for k, s in zip(spec[1], spec[2])}
    if kind == "dc":
        return spec[1](**{n: _build(s, tensors) for n, s in zip(spec[2], spec[3])})
    return (list if kind == "list" else tuple)(_build(s, tensors) for s in spec[1])


def _tensors_of(tree: Any) -> list:
    out: list = []
    _flatten(tree, out)
    return out


def _device_of(tensors: list) -> torch.device | None:
    return next((t.device for t in tensors), None)


# ---------------------------------------------------------------------------
# what a warm-up may touch: parameters, buffers, optimizer state
# ---------------------------------------------------------------------------

# the per-parameter state of torch's Adam, and a fresh optimizer's value of
# each: what a warm-up that created it leaves behind, reset
_FRESH_OPTIMIZER_STATE = {"step": 0.0, "exp_avg": 0.0, "exp_avg_sq": 0.0, "max_exp_avg_sq": 0.0}


def _stateful(tree: Any, out: dict) -> None:
    """The modules, optimizers, objects with `state_dict` and
    `load_state_dict`, and tensors of an argument tree (containers and
    dataclass instances are walked; nothing else is looked into)."""
    if isinstance(tree, (torch.Tensor, torch.nn.Module, torch.optim.Optimizer)):
        out.setdefault(id(tree), tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _stateful(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _stateful(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _stateful(getattr(tree, f.name), out)
    elif callable(getattr(tree, "state_dict", None)) and callable(getattr(tree, "load_state_dict", None)):
        out.setdefault(id(tree), tree)


def _copy(v: Any) -> Any:
    return v.detach().clone() if isinstance(v, torch.Tensor) else v


class _Untouched:
    """Put back, after a warm-up on example arguments, the state the warm-up
    is known to change: each module's parameters and buffers, each
    optimizer's state (its param groups' values, and per parameter the
    state it had, or a fresh optimizer's: `_FRESH_OPTIMIZER_STATE`; any
    other key it created raises), each other object with `state_dict` and
    `load_state_dict` through those, and the argument tensors themselves."""

    def __init__(self, args: tuple):
        self.objects: dict = {}
        _stateful(args, self.objects)

    def __enter__(self):
        self.saved = {}
        with torch.no_grad():
            for k, obj in self.objects.items():
                if isinstance(obj, torch.Tensor):
                    self.saved[k] = obj.detach().clone()
                elif isinstance(obj, torch.nn.Module):
                    self.saved[k] = {n: t.detach().clone() for n, t in obj.state_dict(keep_vars=True).items()}
                elif isinstance(obj, torch.optim.Optimizer):
                    groups = [{n: v for n, v in g.items() if n != "params"} for g in obj.param_groups]
                    state = {id(p): {n: _copy(v) for n, v in st.items()} for p, st in obj.state.items()}
                    self.saved[k] = (groups, state)
                else:
                    self.saved[k] = {n: _copy(v) for n, v in obj.state_dict().items()}
        return self

    def __exit__(self, *exc) -> None:
        with torch.no_grad():
            for k, obj in self.objects.items():
                saved = self.saved[k]
                if isinstance(obj, torch.Tensor):
                    obj.copy_(saved)
                elif isinstance(obj, torch.nn.Module):
                    for n, t in obj.state_dict(keep_vars=True).items():
                        t.copy_(saved[n])
                elif isinstance(obj, torch.optim.Optimizer):
                    self._restore_optimizer(obj, *saved)
                else:
                    obj.load_state_dict(saved)
        self.saved = {}

    @staticmethod
    def _restore_optimizer(opt: torch.optim.Optimizer, groups: list, state: dict) -> None:
        for g, values in zip(opt.param_groups, groups):
            g.update(values)
        for p, st in opt.state.items():
            before = state.get(id(p))
            for n, v in st.items():
                if before is not None and n in before:
                    if isinstance(v, torch.Tensor):
                        v.copy_(before[n])
                    else:
                        st[n] = before[n]
                elif n in _FRESH_OPTIMIZER_STATE and isinstance(v, torch.Tensor):
                    v.fill_(_FRESH_OPTIMIZER_STATE[n])
                else:
                    raise RuntimeError(f"the warm-up created the optimizer state {n!r}, whose fresh value is "
                                       "unknown: register the step without --warm_compile on")


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------


def _counters() -> dict:
    from ..ops.kernels import launch_counters

    return launch_counters()


def _counts(counters: dict) -> dict[str, int]:
    return {k: fn.launches for k, fn in counters.items()}


# ---------------------------------------------------------------------------
# backends: CUDA graphs, and the static buffers alone (CPU tests)
# ---------------------------------------------------------------------------


class _CudaGraphs:
    """Warm-up on a side stream, capture into a `torch.cuda.CUDAGraph`."""

    def warm(self, fn: Callable, args: tuple, device: torch.device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args)
        cur.wait_stream(side)
        return out

    def capture(self, fn: Callable, args: tuple, device: torch.device, like: Any):
        """-> (replay, the static outputs, the graph pool's bytes)."""
        del like
        with torch.cuda.device(device):
            # a garbage collection inside the capture may destroy a dead
            # graph of an earlier run, a CUDA call that invalidates this
            # capture: collect first, and not while capturing
            gc.collect()
            # the capture empties the allocator's cache first: so do we, so
            # that the difference is the graph's pool alone
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0)
            graph = torch.cuda.CUDAGraph()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    out = fn(*args)
            finally:
                if collecting:
                    gc.enable()
            after = torch.cuda.memory_stats(device).get("reserved_bytes.all.current", 0)
        return graph.replay, out, max(int(after - before), 0)


class _StaticBuffers:
    """The copy-in and copy-out of a graph without the graph: a "replay"
    runs the step on the static inputs and copies its results into the
    static outputs, made at capture from the first call's results."""

    def warm(self, fn: Callable, args: tuple, device: torch.device):
        del device
        return fn(*args)

    def capture(self, fn: Callable, args: tuple, device: torch.device, like: Any):
        del device
        spec = _flatten(like, [])
        static = [t.detach().clone() for t in _tensors_of(like)]
        out = _build(spec, iter(static))

        def replay():
            results = _tensors_of(fn(*args))
            with torch.no_grad():
                for dst, src in zip(static, results):
                    dst.copy_(src)

        nbytes = sum(t.numel() * t.element_size() for t in static + _tensors_of(args))
        return replay, out, nbytes


# ---------------------------------------------------------------------------
# entries and the plan
# ---------------------------------------------------------------------------


class _Entry:
    __slots__ = (
        "name", "fn", "example", "role", "spec", "static_in", "static_out", "replay",
        "compile_seconds", "peak_bytes", "aot_calls", "eager_calls", "fallbacks", "error", "delta", "adopt",
        "static_args",
    )

    def __init__(self, name: str, fn: Callable, example: Callable | None, role: str | None, adopt: bool):
        self.name = name
        self.fn = fn
        self.example = example
        self.role = role
        self.adopt = adopt
        self.spec: tuple | None = None
        self.static_in: list = []
        self.static_out: Any = None
        self.replay: Callable | None = None
        self.compile_seconds = 0.0
        self.peak_bytes: int | None = None
        self.aot_calls = 0  # replays
        self.eager_calls = 0  # warm-ups (the first call's, or start()'s) and fallbacks
        self.fallbacks = 0
        self.error: str | None = None
        self.delta: dict[str, int] = {}  # a replay's kernel launches, by counter
        self.static_args: tuple | None = None  # the static inputs, as the call's argument tree


class WarmJit:
    """The callable a main uses in place of its raw step. Direct call on the
    CPU; on CUDA: warm-up and capture at the first call (unless `start()`
    captured already), a replay at every later call whose signature matches
    the capture's, an eager call that counts a fallback otherwise. The first
    completed call of a `role="update"` entry stamps the plan's
    `time_to_first_update_seconds`."""

    __slots__ = ("_entry", "_plan")

    def __init__(self, entry: _Entry, plan: "CompilePlan"):
        self._entry = entry
        self._plan = plan

    def static_args(self) -> tuple | None:
        """The captured call's arguments with the static input tensors in
        place of its own (None before the capture, and on the CPU). A
        caller that writes an input into them once and then passes them
        saves the copy at every later call: a call copies no argument that
        already is its static input."""
        return self._entry.static_args

    def __call__(self, *args):
        e, plan = self._entry, self._plan
        if plan.mode == "direct":
            out = e.fn(*args)
        else:
            tensors: list = []
            spec = _flatten(args, tensors)
            if e.replay is None:
                out = plan._warm(e, args, _device_of(tensors))
                plan._capture(e, tensors, spec, out)
            elif not _same(spec, e.spec):
                e.fallbacks += 1
                e.eager_calls += 1
                plan._event("compile.fallback", jit=e.name, mode="aot_fallback",
                            error="the call's arguments differ from the capture's (shape, dtype, device or a "
                                  "non-tensor argument)")
                out = e.fn(*args)
            else:
                with torch.no_grad():
                    for dst, src in zip(e.static_in, tensors):
                        if dst is not src:
                            dst.copy_(src)
                e.replay()
                e.aot_calls += 1
                out = e.static_out
        if e.role == "update" and plan._first_update_s is None:
            plan._note_first_update()
        return out


class CompilePlan:
    """Registry of a run's hot steps and their graphs (the reference's
    `CompilePlan`, compile/plan.py:257). `mode` is "graph" on a CUDA
    device, "direct" on the CPU; "static" (the copy machinery without
    graphs) is for tests."""

    def __init__(self, enabled: bool = False, telem: Any = None, device: Any = "cpu", mode: str | None = None):
        self.enabled = enabled
        self.device = torch.device(device)
        self.mode = mode or ("graph" if self.device.type == "cuda" else "direct")
        if self.mode not in ("graph", "static", "direct"):
            raise ValueError(f"mode must be 'graph', 'static' or 'direct', got {self.mode!r}")
        self._backend = _CudaGraphs() if self.mode == "graph" else _StaticBuffers()
        self._telem = telem
        self._entries: list[_Entry] = []
        self._started = False
        self._closed = False
        self._t0 = time.perf_counter()
        self._first_update_s: float | None = None

    @classmethod
    def from_args(cls, args: Any, telem: Any = None) -> "CompilePlan":
        return cls(enabled=getattr(args, "warm_compile", "off") == "on", telem=telem,
                   device=getattr(args, "device", "cpu"))

    # ---- registration ------------------------------------------------------
    def register(self, name: str, fn: Callable, example: Callable[[], tuple] | None = None,
                 role: str | None = None, adopt: bool = False) -> WarmJit:
        """Register a step with a thunk producing example call arguments
        (evaluated at `start()` under `--warm_compile on`). Returns the
        callable the main uses in place of `fn`. With `adopt`, the tensors
        of the capturing call (or of the example) are the caller's own
        persistent buffers: the graph reads them in place, and a later call
        that passes the same tensors copies nothing."""
        entry = _Entry(name, fn, example, role, adopt)
        self._entries.append(entry)
        return WarmJit(entry, self)

    # ---- capture -------------------------------------------------------------
    def start(self) -> None:
        """With `--warm_compile on`, warm up and capture every entry with an
        example, here, before the loop; otherwise only anchor the
        first-update clock. Idempotent."""
        if self._started:
            return
        self._started = True
        self._t0 = time.perf_counter()
        if not self.enabled or self.mode == "direct":
            return
        for e in self._entries:
            if e.replay is not None or e.example is None:
                continue
            args = tuple(e.example())
            tensors: list = []
            spec = _flatten(args, tensors)
            with _Untouched(args):
                out = self._warm(e, args, _device_of(tensors))
            self._capture(e, tensors, spec, out)

    def _warm(self, e: _Entry, args: tuple, device) -> Any:
        t0 = time.perf_counter()
        out = self._backend.warm(e.fn, args, device)
        e.eager_calls += 1
        e.compile_seconds += time.perf_counter() - t0
        return out

    def _capture(self, e: _Entry, tensors: list, spec: tuple, like: Any) -> None:
        t0 = time.perf_counter()
        with torch.no_grad():
            static = list(tensors) if e.adopt else [t.detach().clone() for t in tensors]
        args = _build(spec, iter(static))
        counters = _counters()
        before = _counts(counters)
        try:
            replay, out, nbytes = self._backend.capture(e.fn, args, _device_of(tensors) or self.device, like)
        except Exception as err:
            e.error = f"{type(err).__name__}: {err}"[:300]
            self._event("compile", jit=e.name, mode="capture", error=e.error)
            raise RuntimeError(f"capturing {e.name} as a CUDA graph failed: {e.error}") from err
        after = _counts(counters)  # what the capture recorded: a replay's launches
        e.delta = {k: after[k] - before[k] for k in counters if after[k] != before[k]}
        e.spec, e.static_in, e.static_out, e.replay = spec, static, out, replay
        e.static_args = args
        e.peak_bytes = nbytes
        e.compile_seconds += time.perf_counter() - t0
        self._event("compile", jit=e.name, mode="capture", seconds=round(e.compile_seconds, 4),
                    peak_bytes=nbytes, launches=e.delta, error=None)

    def wait(self, timeout: float | None = None) -> bool:
        """Every capture is done by the calling thread before it returns,
        so there is never anything to wait for."""
        del timeout
        return True

    # ---- observability -----------------------------------------------------
    def _event(self, name: str, **data: Any) -> None:
        if self._telem is not None:
            try:
                self._telem.event(name, **data)
            except Exception:
                pass  # telemetry must never kill the compile path

    def _note_first_update(self) -> None:
        self._first_update_s = time.perf_counter() - self._t0
        self._event("first_update", seconds=round(self._first_update_s, 3),
                    warm_compile="on" if self.enabled else "off")

    def stats(self) -> dict[str, Any]:
        return {
            "enabled": self.enabled,
            "mode": self.mode,
            "entries": {
                e.name: {
                    "compiled": e.replay is not None,
                    "compile_seconds": e.compile_seconds,
                    "aot_calls": e.aot_calls,
                    "eager_calls": e.eager_calls,
                    "fallbacks": e.fallbacks,
                    "error": e.error,
                    "peak_bytes": e.peak_bytes,
                    "launches_per_replay": dict(e.delta),
                }
                for e in self._entries
            },
            "time_to_first_update_seconds": self._first_update_s,
        }

    def gauges(self) -> dict[str, float]:
        """`Compile/*` gauge source for Telemetry.add_gauges: the
        reference's keys, less its compile-cache counters."""
        entries = list(self._entries)
        out = {
            "Compile/warm_enabled": float(self.enabled),
            "Compile/plan_entries": float(len(entries)),
            "Compile/plan_compiled": float(sum(1 for e in entries if e.replay is not None)),
            "Compile/warm_compile_seconds": sum(e.compile_seconds for e in entries),
            "Compile/aot_calls": float(sum(e.aot_calls for e in entries)),
            "Compile/aot_fallbacks": float(sum(e.fallbacks for e in entries)),
            # captures run on the calling thread: no call ever waits on one
            "Compile/barrier_wait_seconds": 0.0,
        }
        for e in entries:
            if e.compile_seconds:
                out[f"Compile/exe/{e.name}_seconds"] = e.compile_seconds
            if e.peak_bytes is not None:
                out[f"Compile/exe/{e.name}_peak_bytes"] = float(e.peak_bytes)
        peaks = [e.peak_bytes for e in entries if e.peak_bytes is not None]
        if peaks:
            out["Compile/plan_peak_bytes_max"] = float(max(peaks))
        if self._first_update_s is not None:
            out["Compile/time_to_first_update_seconds"] = self._first_update_s
        return out

    # ---- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        """End of run: the summary event (the graphs stay with their
        entries until the plan is collected)."""
        if self._closed:
            return
        self._closed = True
        if self._entries or self._first_update_s is not None:
            self._event("compile.summary", **self.stats())


def graphed(name: str, fn: Callable, device: Any, telem: Any = None) -> WarmJit:
    """`fn` as a graphed callable of its own, outside any run's plan: the
    candidates `compile/decisions.py:decide` times (the reference times its
    AOT executables). Its first call warms up and captures; direct on the
    CPU."""
    return CompilePlan(device=device, telem=telem).register(name, fn)
