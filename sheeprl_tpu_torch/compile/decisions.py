"""Measured decisions (the port of sheeprl_tpu/compile/decisions.py:226-575
and :622-649, the parts `serve/quant.py:accept_rungs` and
`serve/ladder.py:size_ladder` need).

A decision times a ladder of candidates on one example and keeps a winner:

    candidate -> one untimed call (its time, which includes building a
                 kernel at first use, is `compile_seconds`) -> `REPEATS`
                 timed calls, each ended by a device synchronise (median)
              -> peak device bytes (`torch.cuda.max_memory_allocated` after
                 a reset; None on the CPU)
              -> a receipt against the first candidate, the baseline:
                 bit-exact outputs, or, with `quality_metric` and
                 `quality_bound`, a measured divergence within the bound
              -> the fastest candidate that holds its receipt.

Unlike the reference, a candidate that raises aborts the decision instead
of losing it: every candidate of the port's one ladder (f32 against the
int8 kernel) is a path that serves, so a kernel that fails to build or
launch must stop the process, never leave the rungs quietly on f32.

Decisions persist in a JSON store keyed by family, name, the example's
shapes and dtypes, the torch version and the device's name, so a re-run on
the same shapes and card reads the winner back. Time is the only
objective: the reference's `bytes` objective and `decide_remat` come with
`--remat` (ROADMAP Queue A item 5); the legacy scan-unroll migration is
not ported.

`measured_probe` memoizes one measurement (the serve ladder's peak bytes)
in the same store, under the same key as a decision on that example.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Sequence

import torch

__all__ = [
    "CandidateReport",
    "Decision",
    "cached_decision",
    "decide",
    "decision_key",
    "load_cache",
    "measured_probe",
    "tree_leaves",
]

REPEATS = 3  # timed calls per candidate; the median is its time


def load_cache(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _save_cache(path: str, store: dict) -> None:
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(store, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # the store is an optimization; never fail the run on it


def tree_leaves(tree: Any) -> list:
    """The tensors (and other leaves) of a tensor, or of lists, tuples and
    dicts of them, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def _device_of(example: Sequence[Any]) -> torch.device:
    for leaf in tree_leaves(example):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def decision_key(family: str, name: str, example: Sequence[Any]) -> str:
    """The store key: family + probe name + the example's shapes and dtypes
    + the torch version + the device's name. A decision measured on other
    shapes, another toolchain or another card never leaks."""
    avals = ",".join(
        f"{str(leaf.dtype).replace('torch.', '')}{list(leaf.shape)}" if isinstance(leaf, torch.Tensor)
        else type(leaf).__name__
        for leaf in tree_leaves(example)
    )
    return f"{family}|{name}|{avals}|torch{torch.__version__}|{_device_name(_device_of(example))}"


@dataclasses.dataclass
class CandidateReport:
    """One rung of one ladder: what its first call cost, what a call costs,
    the device memory it peaked at, and whether it held its receipt."""

    label: str
    exec_seconds: float | None = None
    compile_seconds: float | None = None
    bit_exact: bool | None = None
    peak_bytes: int | None = None
    # bounded-divergence acceptance: with a quality_metric every candidate
    # carries its divergence from the baseline and whether it stayed within
    # quality_bound; bit-exact ladders leave both None
    divergence: float | None = None
    within_bound: bool | None = None

    def as_dict(self) -> dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items() if k != "label"}


@dataclasses.dataclass
class Decision:
    """One measured ladder and its winner. `accepted` means the winner
    differs from the baseline."""

    family: str
    name: str
    winner: str
    baseline: str
    candidates: dict[str, dict]  # label -> CandidateReport.as_dict()
    accepted: bool
    source: str  # "measured" | "cache"
    key: str
    # the bound the ladder was accepted under (None for bit-exact ladders):
    # stored next to the winner, so the store entry is the receipt
    quality_bound: float | None = None

    def candidate(self, label: str) -> dict:
        return self.candidates.get(str(label), {})

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Decision":
        return cls(
            family=str(d.get("family", "")),
            name=str(d.get("name", "")),
            winner=str(d.get("winner", "")),
            baseline=str(d.get("baseline", "")),
            candidates={str(k): dict(v) for k, v in d.get("candidates", {}).items()},
            accepted=bool(d.get("accepted", False)),
            source="cache",
            key=str(d.get("key", "")),
            quality_bound=d.get("quality_bound"),
        )


def cached_decision(path: str, key: str) -> Decision | None:
    rec = load_cache(path).get(key)
    if not isinstance(rec, dict) or "candidates" not in rec:
        return None
    return Decision.from_dict({**rec, "key": key})


def _bit_exact(a: Any, b: Any) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if not isinstance(x, torch.Tensor) or not isinstance(y, torch.Tensor):
            if x != y:
                return False
            continue
        if x.shape != y.shape or x.dtype != y.dtype:
            return False
        same = x == y
        if x.is_floating_point():
            same = same | (x.isnan() & y.isnan())
        if not bool(same.all()):
            return False
    return True


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decide(
    family: str,
    name: str,
    candidates: Sequence[Any],
    build: Callable[[Any], Callable],
    example: Sequence[Any],
    *,
    store_path: str | None = None,
    quality_metric: Callable[[Any, Any], float] | None = None,
    quality_bound: float | None = None,
) -> Decision:
    """Measure one candidate ladder and return (and persist, when
    `store_path` is given) the decision.

    `build(candidate)` returns the callable for that candidate, called as
    `fn(*example)` under `torch.inference_mode()`. First the baseline (the
    first candidate) is called once, untimed, to absorb the process's
    one-time costs; then each candidate gets one untimed call and `REPEATS`
    timed calls (median). A candidate that raises, or a quality metric that
    raises, aborts the decision with its error. A candidate whose outputs
    are not bit-identical to the baseline's is disqualified, unless
    `quality_metric(baseline_out, candidate_out) <= quality_bound`. The
    winner is the fastest survivor, ties broken toward ladder order."""
    if (quality_metric is None) != (quality_bound is None):
        raise ValueError("quality_metric and quality_bound come together")
    labels = [str(c) for c in candidates]
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate candidate labels in {labels}")
    key = decision_key(family, name, example)
    if store_path:
        hit = cached_decision(store_path, key)
        if hit is not None:
            return hit

    device = _device_of(example)
    reports: dict[str, CandidateReport] = {}
    outputs: dict[str, Any] = {}
    with torch.inference_mode():
        build(candidates[0])(*example)  # the process's warm-up
        _synchronize(device)
        for value, label in zip(candidates, labels):
            report = CandidateReport(label=label)
            reports[label] = report
            fn = build(value)
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            out = fn(*example)
            _synchronize(device)
            report.compile_seconds = time.perf_counter() - t0
            samples = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                out = fn(*example)
                _synchronize(device)
                samples.append(time.perf_counter() - t0)
            if device.type == "cuda":
                report.peak_bytes = int(torch.cuda.max_memory_allocated(device))
            samples.sort()
            report.exec_seconds = samples[len(samples) // 2]
            outputs[label] = out

    baseline = labels[0]
    for label in labels:
        rep = reports[label]
        rep.bit_exact = True if label == baseline else _bit_exact(outputs[baseline], outputs[label])
        if quality_metric is None:
            continue
        rep.divergence = 0.0 if label == baseline else float(quality_metric(outputs[baseline], outputs[label]))
        rep.within_bound = rep.divergence <= quality_bound

    winner = _pick_winner(labels, reports)
    decision = Decision(
        family=family, name=name, winner=winner, baseline=baseline,
        candidates={lbl: rep.as_dict() for lbl, rep in reports.items()},
        accepted=winner != baseline, source="measured", key=key, quality_bound=quality_bound,
    )
    if store_path:
        store = load_cache(store_path)
        store[key] = decision.as_dict()
        _save_cache(store_path, store)
    return decision


def _pick_winner(labels: list[str], reports: dict[str, CandidateReport]) -> str:
    """The fastest candidate that survives on either receipt (bit-exact, or
    a measured divergence within the bound); ties break toward ladder
    order. The baseline always survives."""
    eligible = [lbl for lbl in labels if reports[lbl].bit_exact or reports[lbl].within_bound]
    return min(eligible, key=lambda lbl: (reports[lbl].exec_seconds, labels.index(lbl)))


def measured_probe(
    family: str,
    name: str,
    example: Sequence[Any],
    measure: Callable[[], dict],
    *,
    store_path: str | None = None,
    force: bool = False,
) -> tuple[dict, str]:
    """Memoize one expensive measurement in the decision store, keyed as a
    decision on `example` would be (`decision_key`). Returns `(record,
    source)` with source "measured" or "cache". The record must be JSON;
    a record with an `error` is not stored, so the next call measures
    again. The decision drawn from the record (the caller's, from the
    current budget) is never stored: only the measurement is."""
    key = decision_key(family, name, example)
    if store_path and not force:
        rec = load_cache(store_path).get(key)
        if isinstance(rec, dict) and "probe" in rec:
            return dict(rec["probe"]), "cache"
    record = measure()
    if store_path and not record.get("error"):
        store = load_cache(store_path)
        store[key] = {"family": family, "name": name, "key": key, "probe": record}
        _save_cache(store_path, store)
    return record, "measured"
