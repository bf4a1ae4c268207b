"""Batch-ladder sizing for the serving tier (the port of
sheeprl_tpu/serve/ladder.py).

The server dispatches micro-batches through one fixed-shape step per
ladder rung (1, 2, 4, ... up to --max_batch), each a CUDA graph on the card
that holds its memory pool for the life of the server, so the ladder is
sized, not assumed: a rung is kept when its measured peak bytes fit the
serving memory budget (`serve_mem_budget_bytes`: SHEEPRL_TPU_SERVE_MEM_MB,
else the partition budget, SHEEPRL_TPU_PARTITION_MEM_MB or 512 MiB).

The probe stands in for the reference's trial compile and XLA
`memory_analysis()`: the peak of a rung is the bytes of its arguments (the
params' parameters and buffers, the state and obs tensors, each storage
counted once) plus what the caching allocator rose by during one eager call
of the step on the card (`torch.cuda.reset_peak_memory_stats`, then
`max_memory_allocated` less `memory_allocated` before the call). On the CPU
no allocator reports a rise: the probe there counts the arguments and the
call's outputs, a lower bound of the peak. Each measurement is memoized in
`serve_ladder.json` (`compile/decisions.py:measured_probe`, keyed as a
decision on the rung's example), so a restarted server never probes again;
the decision itself is drawn anew from the current budget.

The rules are the reference's: the smallest rung is always kept (source
`floor` when over the budget: a server that can serve nothing is not a
server); another rung over the budget is refused; a rung whose probe fails
is kept with source `error` (refusing to serve on a broken probe is worse
than serving).

The reference first reads a rung's peak from its committed memory ledger
(the sheepmem `@serve` capture entries, scaled by the argument bytes) and
probes only without one; the port has no committed memory ledger, so that
step waits for `analysis/` (ROADMAP Queue A item 10).

`derive_rung` is the occupancy re-tier's candidate (serve.py:
`_maybe_retier`): the batch size the live dispatches actually carry.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable

import torch

from ..compile.partition import partition_mem_budget_bytes

__all__ = [
    "RungDecision",
    "derive_rung",
    "example_arg_bytes",
    "ledger_spec",
    "parse_rungs",
    "serve_mem_budget_bytes",
    "size_ladder",
]

FAMILY = "serve_ladder"


def parse_rungs(ladder: str, max_batch: int) -> list[int]:
    """'auto' -> powers of two up to max_batch (always including
    max_batch); '1,2,8' -> that list, validated and sorted."""
    if ladder == "auto":
        rungs = []
        r = 1
        while r < max_batch:
            rungs.append(r)
            r *= 2
        rungs.append(max_batch)
        return rungs
    try:
        rungs = sorted({int(tok) for tok in ladder.split(",") if tok.strip()})
    except ValueError:
        raise ValueError(f"unparseable ladder {ladder!r} (want e.g. '1,2,8')")
    if not rungs or rungs[0] < 1:
        raise ValueError(f"ladder rungs must be >= 1, got {ladder!r}")
    if rungs[-1] > max_batch:
        raise ValueError(f"ladder rung {rungs[-1]} exceeds --max_batch {max_batch}")
    return rungs


def derive_rung(avg_rows: float, rungs: list[int], max_batch: int) -> int | None:
    """The intermediate batch size live dispatches carry (their mean rows,
    rounded). None when the candidate is degenerate (<= 0), already a rung,
    over --max_batch, or within 1 of the rung it would relieve (padding one
    row is cheaper than holding another graph)."""
    cand = int(round(avg_rows))
    if cand <= 0 or cand in rungs or cand > max_batch:
        return None
    above = [r for r in rungs if r >= cand]
    if not above or above[0] - cand < 2:
        return None
    return cand


def ledger_spec(algo: str) -> str:
    """The capture-spec name a rung's key is made of: `serve` for SAC (the
    reference's capture default), `<algo>@serve` for the others."""
    return "serve" if algo == "sac" else f"{algo}@serve"


def serve_mem_budget_bytes() -> int:
    """Peak-bytes budget of one rung: SHEEPRL_TPU_SERVE_MEM_MB, else the
    partition budget (`compile/partition.py:partition_mem_budget_bytes`)."""
    env = os.environ.get("SHEEPRL_TPU_SERVE_MEM_MB")
    if env:
        return int(float(env) * 2**20)
    return partition_mem_budget_bytes()


@dataclasses.dataclass
class RungDecision:
    rung: int
    accepted: bool
    source: str  # 'probe' | 'floor' | 'error'
    peak_bytes: int
    reason: str

    def as_event(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def _tensors_of(tree: Any, out: list) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, torch.nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors_of(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors_of(v, out)


def example_arg_bytes(example: Any) -> int:
    """The bytes of an argument tree's tensors (a module's parameters and
    buffers included), each storage counted once: a quantized twin's
    modules shared with the f32 player are not counted twice."""
    tensors: list = []
    _tensors_of(example, tensors)
    seen: dict[tuple, int] = {}
    for t in tensors:
        storage = t.untyped_storage()
        seen[(t.device.type, t.device.index, storage.data_ptr())] = storage.nbytes()
    return int(sum(seen.values()))


def _device_of(example: Any) -> torch.device:
    tensors: list = []
    _tensors_of(example, tensors)
    return tensors[0].device if tensors else torch.device("cpu")


def _probe(fn: Callable, example: tuple) -> dict:
    """One eager call of the rung's step: {peak_bytes, argument_bytes,
    rise_bytes}, or {error} when the call fails."""
    args_b = example_arg_bytes(example)
    device = _device_of(example)
    try:
        with torch.inference_mode():
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                before = torch.cuda.memory_allocated(device)
                out = fn(*example)
                torch.cuda.synchronize(device)
                rise = torch.cuda.max_memory_allocated(device) - before
            else:  # no allocator statistics: the outputs are what a call is seen to hold
                out = fn(*example)
                outs: list = []
                _tensors_of(out, outs)
                rise = sum(t.numel() * t.element_size() for t in outs)
        del out
    except Exception as err:
        return {"error": f"probe call failed: {type(err).__name__}: {err}"[:300]}
    rise = max(int(rise), 0)
    return {"peak_bytes": args_b + rise, "argument_bytes": args_b, "rise_bytes": rise}


def size_ladder(
    fn: Callable,
    example_of: Callable[[int], tuple],
    rungs: list[int],
    spec: str,
    mem_budget_bytes: int | None = None,
    store_path: str | None = None,
) -> list[RungDecision]:
    """Decide, per requested rung, whether its step fits the serving memory
    budget. `fn` is the rung's step, called eagerly as `fn(*example)`;
    `example_of(rung)` gives its exact call arguments. Returns one
    RungDecision per rung, in order."""
    budget = serve_mem_budget_bytes() if mem_budget_bytes is None else mem_budget_bytes
    decisions: list[RungDecision] = []
    for rung in rungs:
        peak, note = _predict_peak(fn, example_of(rung), spec, rung, store_path)
        if peak is None:
            decisions.append(RungDecision(rung, True, "error", 0, f"unmeasured ({note}); kept"))
        elif peak <= budget:
            decisions.append(RungDecision(
                rung, True, "probe", peak,
                f"peak {peak / 2**20:.1f}MiB within budget {budget / 2**20:.1f}MiB ({note})"))
        elif rung == min(rungs):
            decisions.append(RungDecision(
                rung, True, "floor", peak,
                f"peak {peak / 2**20:.1f}MiB EXCEEDS budget {budget / 2**20:.1f}MiB but the smallest rung is "
                f"always kept ({note})"))
        else:
            decisions.append(RungDecision(
                rung, False, "probe", peak,
                f"peak {peak / 2**20:.1f}MiB > budget {budget / 2**20:.1f}MiB ({note})"))
    return decisions


def _predict_peak(fn: Callable, example: tuple, spec: str, rung: int,
                  store_path: str | None) -> tuple[int | None, str]:
    """-> (peak bytes | None, note): the probe's, memoized."""
    from ..compile import decisions as dec

    record, src = dec.measured_probe(FAMILY, f"{spec}/policy_b{rung}", example, lambda: _probe(fn, example),
                                     store_path=store_path)
    if record.get("error"):
        return None, record["error"]
    return int(record.get("peak_bytes", 0)), "probe cache" if src == "cache" else "probe"
