"""The run-wide telemetry every main builds (the port of
sheeprl_tpu/telemetry/core.py): phase timers, a NaN/inf watchdog over the
logged metrics, the gauge sources, a JSONL event log on process 0 and a
periodic one-line console heartbeat.

    telem = Telemetry.from_args(args, log_dir, algo="ppo")
    telem.mark("rollout")              # or: with telem.phase("rollout"): ...
    metrics = telem.interval(aggregator.compute(), global_step, sps)
    telem.close()

`interval()` merges the phase seconds (`Time/<phase>_seconds`, and
`Time/<phase>_sps` where steps passed) and every registered gauge source
into the metrics, runs the watchdog (`Health/nonfinite_metrics`, a
`health.nan` event), appends an interval record to
`<log_dir>/telemetry.jsonl` and prints the heartbeat when it is due.
Everything is host bookkeeping: nothing waits for the device.

Kill switch: SHEEPRL_TPU_TELEMETRY=0 turns the subsystem off
(`from_args` builds a writer that writes nothing, and `interval()` returns
the metrics untouched). The port's interval record keeps its own name,
`"event": "interval"` with `step`, `sps` and `metrics` (the reference's is
`"log"`), and every record carries the writer's `role`. Not ported: the
reference's XLA recompile tracker (a CUDA graph's captures are the plan's
`Compile/*` gauges), its per-device memory gauges, its crash hook and the
thread sanitizer (ROADMAP Queue A item 10).

Every open `Telemetry` is registered, and the module-level `emit`
publishes an event to each, so a helper without a handle (the profiler
window, `utils/profiler.py`) still leaves its record. `Telemetry.tracer` is
the shard's span emitter (`telemetry/trace.py`), built at first use.
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Any, Callable, Iterator

from .events import JsonlEventLog
from .phase import PhaseTimers

__all__ = ["Telemetry", "active_telemetry", "emit"]

TELEMETRY_ENV = "SHEEPRL_TPU_TELEMETRY"

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

    def __init__(self, log_dir: str | None, role: str = "", rank: int = 0, algo: str = "",
                 enabled: bool = True, heartbeat_s: float = 30.0, run_id: str | None = None):
        self.enabled = enabled  # read by the tracer: a closed or disabled writer emits no span
        self.rank = rank
        self.algo = algo
        self.role = role or "learner"
        self.run_id = run_id
        self.log_dir = log_dir
        self.heartbeat_s = heartbeat_s
        self.timers = PhaseTimers()
        self._gauges: list[Callable[[], dict[str, float]]] = []
        self._last_step: int | None = None
        self._last_heartbeat = time.monotonic()
        self._last_nan_warn = 0.0
        self._tracer = None
        write = enabled and rank == 0 and log_dir is not None
        self._log = JsonlEventLog(os.path.join(log_dir, self.FILENAME) if write else None)
        if enabled:
            _active.append(self)

    @classmethod
    def from_args(cls, args: Any, log_dir: str, rank: int = 0, algo: str = "", role: str = "") -> "Telemetry":
        """The mains' construction: on unless SHEEPRL_TPU_TELEMETRY=0, the
        JSONL and the heartbeat on process 0 only, and a `start` event
        with the run's identity."""
        import torch

        from .trace import ensure_run_id

        enabled = os.environ.get(TELEMETRY_ENV, "1") != "0"
        telem = cls(log_dir, role=role, rank=rank, algo=algo, enabled=enabled,
                    run_id=ensure_run_id() if enabled else None)
        if enabled:
            device = str(getattr(args, "device", "cpu"))
            telem.event(
                "start", algo=algo, env_id=getattr(args, "env_id", None), seed=getattr(args, "seed", None),
                num_envs=getattr(args, "num_envs", None), precision=getattr(args, "precision", None),
                device=device, local_devices=torch.cuda.device_count() if device.startswith("cuda") else 1,
                rank=rank, log_dir=log_dir, run=telem.run_id,
            )
        return telem

    @property
    def tracer(self):
        """This shard's span emitter (`telemetry/trace.py:Tracer`)."""
        if self._tracer is None:
            from .trace import Tracer

            self._tracer = Tracer(self)
        return self._tracer

    # ---- phase timing -----------------------------------------------------
    def phase(self, name: str) -> Iterator[None]:
        return self.timers.phase(name)

    def mark(self, name: str | None) -> None:
        if self.enabled:
            self.timers.mark(name)

    # ---- gauges and events --------------------------------------------------
    def add_gauges(self, source: Callable[[], dict[str, float]]) -> None:
        """Register a callable polled at every interval."""
        self._gauges.append(source)

    def event(self, event: str, /, **data: Any) -> None:
        self._log.emit(event, role=self.role, **data)

    def interval(self, metrics: dict[str, Any], step: int, sps: float | None = None) -> dict[str, Any]:
        """Merge this interval's phase times and gauges into `metrics` (a
        new dict), run the NaN watchdog, append the interval record and
        print the heartbeat when due. -> the merged metrics."""
        if not self.enabled:
            return metrics
        out = dict(metrics)
        dstep = None if self._last_step is None else step - self._last_step
        for name, secs in self.timers.flush().items():
            out[f"Time/{name}_seconds"] = secs
            if dstep and secs > 0.0:
                out[f"Time/{name}_sps"] = dstep / secs
        for source in self._gauges:
            out.update(source())
        self._nan_watchdog(out, step)
        self._last_step = step
        self.event("interval", step=step, sps=sps, metrics=out)
        now = time.monotonic()
        if self.rank == 0 and now - self._last_heartbeat >= self.heartbeat_s:
            self._heartbeat(out, step, sps)
            self._last_heartbeat = now
        return out

    def _nan_watchdog(self, merged: dict[str, Any], step: int) -> None:
        bad = {k: repr(v) for k, v in merged.items() if isinstance(v, float) and not math.isfinite(v)}
        if not bad:
            return
        merged["Health/nonfinite_metrics"] = float(len(bad))
        self.event("health.nan", step=step, keys=sorted(bad), values=bad)
        now = time.monotonic()
        if self.rank == 0 and now - self._last_nan_warn >= self.heartbeat_s:
            print(f"[telemetry {self.algo}] WARNING: non-finite metrics at step {step}: {sorted(bad)}",
                  file=sys.stderr)
            self._last_nan_warn = now

    def _heartbeat(self, merged: dict[str, Any], step: int, sps: float | None) -> None:
        phases = {k[len("Time/"):-len("_seconds")]: v for k, v in merged.items()
                  if k.startswith("Time/") and k.endswith("_seconds")}
        total = sum(phases.values())
        if total > 0:
            top = sorted(phases.items(), key=lambda kv: -kv[1])[:4]
            breakdown = " ".join(f"{n} {100 * s / total:.0f}%" for n, s in top)
        else:
            breakdown = "-"
        bits = [f"[telemetry {self.algo}] step={step}"]
        if sps is not None:
            bits.append(f"sps={sps:.1f}")
        bits.append(f"| {breakdown}")
        print(" ".join(bits), file=sys.stderr)

    def close(self) -> None:
        """End of the run: the open phases' seconds in an `end` event."""
        if self.enabled:
            self.event("end", phases=self.timers.flush())
        self.enabled = False
        if self in _active:
            _active.remove(self)
        self._log.close()
