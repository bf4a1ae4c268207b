"""Anakin collection telemetry (the port of sheeprl_tpu/parallel/anakin.py).

`AnakinStats` is the `Anakin/*` gauge source of the mains that collect on
the device (`--env_backend jax`): the collection rate, the steps a
collector call spans, the env batch and the device count. The mains put
its gauges in their "done" record.

Not ported: `shard_env_batch`, which places a collector carry's `[N, ...]`
leaves over the reference's mesh so that each device steps its own slice
of the envs. The port runs on one card, which has no mesh to shard over
(ROADMAP Queue A item 8 carries it with the rest of `parallel/`)."""

from __future__ import annotations

__all__ = ["AnakinStats"]


class AnakinStats:
    """Collection-side counters of the device-env path:

        anakin = AnakinStats(scan_span=T, env_batch=N, devices=1)
        t0 = time.perf_counter()
        traj, ep = collect(...)            # one graph replay
        ... one pull of the episode dict (the device has retired the rollout)
        anakin.note(T * N, time.perf_counter() - t0)
    """

    def __init__(self, scan_span: int, env_batch: int, devices: int = 1):
        self.scan_span = int(scan_span)
        self.env_batch = int(env_batch)
        self.devices = int(devices)
        self.rollouts = 0
        self.env_steps_total = 0
        self.collect_seconds_total = 0.0
        self._last_sps = 0.0

    def note(self, env_steps: int, seconds: float) -> None:
        self.rollouts += 1
        self.env_steps_total += int(env_steps)
        self.collect_seconds_total += float(seconds)
        if seconds > 0:
            self._last_sps = env_steps / seconds

    @property
    def env_steps_per_second(self) -> float:
        return self._last_sps

    def gauges(self) -> dict[str, float]:
        """The reference's `Anakin/*` gauges."""
        out = {
            "Anakin/env_steps_per_second": self._last_sps,
            "Anakin/scan_span": float(self.scan_span),
            "Anakin/env_batch": float(self.env_batch),
            "Anakin/devices": float(self.devices),
            "Anakin/rollouts": float(self.rollouts),
            "Anakin/env_steps_total": float(self.env_steps_total),
            "Anakin/collect_seconds_total": self.collect_seconds_total,
        }
        if self.collect_seconds_total > 0:
            out["Anakin/env_steps_per_second_avg"] = self.env_steps_total / self.collect_seconds_total
        return out
