"""Metric aggregation (the port of sheeprl_tpu/utils/metric.py): named
running means updated every step and computed, then reset, once a logging
interval, and a windowed moving average.

A value may be a Python number, a numpy scalar or a torch tensor of one
element, on the CPU or on the card (a metric copied out of a graph
replay). Updates keep the value as it is, so the hot loop never waits for
the device; `compute()` (or `PendingMetrics.resolve()`) moves every
pending device value to the host in one copy, a single synchronisation,
before the arithmetic, which is the reference's: a mean of the values as
float64, or the window's mean, std, min and max.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Iterable

import numpy as np
import torch

__all__ = ["MeanMetric", "MetricAggregator", "MovingAverageMetric", "PendingMetrics"]


def _host_values(values: Iterable[Any]) -> dict[int, float]:
    """{id(value): float} for the tensors among `values`: those on a device
    in one stacked copy (one synchronisation), those on the CPU directly."""
    device_vals, out = [], {}
    for v in values:
        if isinstance(v, torch.Tensor) and id(v) not in out:
            if v.device.type == "cpu":
                out[id(v)] = float(v)
            else:
                device_vals.append(v)
                out[id(v)] = 0.0
    if device_vals:
        pulled = torch.stack([v.detach().reshape(()).to(torch.float64) for v in device_vals]).cpu().tolist()
        out.update({id(v): p for v, p in zip(device_vals, pulled)})
    return out


def _floats(values: list[Any], host: dict[int, float] | None = None) -> list[float]:
    host = _host_values(values) if host is None else host
    return [host[id(v)] if isinstance(v, torch.Tensor) else float(v) for v in values]


class _Snapshot:
    """A metric's pending values frozen when the snapshot was taken, with
    the metric's resolve function bound to them."""

    __slots__ = ("values", "_resolve")

    def __init__(self, values: list[Any], resolve) -> None:
        self.values = values
        self._resolve = resolve

    def resolve(self, host: dict[int, float] | None = None):
        return self._resolve(_floats(self.values, host))


class MeanMetric:
    def __init__(self) -> None:
        self._values: list[Any] = []

    def pending(self) -> list[Any]:
        return self._values

    def update(self, value: Any) -> None:
        self._values.append(value)

    @staticmethod
    def _resolve(values: list[float]) -> float | None:
        if not values:
            return None
        return float(np.mean(values))

    def compute(self, host: dict[int, float] | None = None) -> float | None:
        return self._resolve(_floats(self._values, host))

    def snapshot(self) -> _Snapshot:
        return _Snapshot(list(self._values), self._resolve)

    def reset(self) -> None:
        self._values.clear()


class MovingAverageMetric:
    """Statistics over the last `window` values. The window survives the
    aggregator's per-interval reset unless `reset_on_compute`; an explicit
    `reset()` clears it."""

    def __init__(self, window: int = 100, reset_on_compute: bool = False) -> None:
        self._window = deque(maxlen=window)
        self.reset_on_compute = reset_on_compute

    def pending(self) -> list[Any]:
        return list(self._window)

    def update(self, value: Any) -> None:
        self._window.append(value)

    @staticmethod
    def _resolve(values: list[float]) -> dict[str, float] | None:
        if not values:
            return None
        arr = np.asarray(values)
        return {"mean": float(arr.mean()), "std": float(arr.std()), "min": float(arr.min()),
                "max": float(arr.max())}

    def compute(self, host: dict[int, float] | None = None) -> dict[str, float] | None:
        return self._resolve(_floats(list(self._window), host))

    def snapshot(self) -> _Snapshot:
        return _Snapshot(list(self._window), self._resolve)

    def reset(self) -> None:
        self._window.clear()


class MetricAggregator:
    def __init__(self, metrics: dict[str, Any] | None = None) -> None:
        self.metrics: dict[str, Any] = metrics if metrics is not None else {}

    def add(self, name: str, metric: Any | None = None) -> None:
        if name in self.metrics:
            raise ValueError(f"metric {name!r} already exists")
        self.metrics[name] = metric if metric is not None else MeanMetric()

    def update(self, name: str, value: Any) -> None:
        if name not in self.metrics:
            self.add(name)
        self.metrics[name].update(value)

    def pop(self, name: str) -> None:
        self.metrics.pop(name, None)

    @staticmethod
    def _flatten(name: str, val, out: dict) -> None:
        if val is None:
            return
        if isinstance(val, dict):
            for k, v in val.items():
                out[f"{name}/{k}"] = v
        else:
            out[name] = val

    def compute(self) -> dict[str, float]:
        """Every metric's value, dicts flattened as `name/key`; one device
        synchronisation for all pending device values."""
        host = _host_values(v for m in self.metrics.values() for v in m.pending())
        out: dict = {}
        for name, metric in self.metrics.items():
            self._flatten(name, metric.compute(host), out)
        return out

    def snapshot(self) -> "PendingMetrics":
        """Freeze every metric's pending values; `resolve()` later gives what
        `compute()` would have given now."""
        return PendingMetrics({name: m.snapshot() for name, m in self.metrics.items()})

    def reset(self, force: bool = False) -> None:
        """The per-interval reset; a metric with `reset_on_compute` False
        (a moving average) keeps its window unless `force`."""
        for metric in self.metrics.values():
            if force or getattr(metric, "reset_on_compute", True):
                metric.reset()


class PendingMetrics:
    """An interval's values taken by `MetricAggregator.snapshot()`;
    `resolve()` pulls them (one synchronisation) and returns the flattened
    metric dict."""

    __slots__ = ("_snaps",)

    def __init__(self, snaps: dict[str, _Snapshot]) -> None:
        self._snaps = snaps

    def resolve(self) -> dict:
        host = _host_values(v for s in self._snaps.values() for v in s.values)
        out: dict = {}
        for name, snap in self._snaps.items():
            MetricAggregator._flatten(name, snap.resolve(host), out)
        return out
