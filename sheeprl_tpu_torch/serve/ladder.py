"""Batch-ladder rungs for the serving tier (the port of
sheeprl_tpu/serve/ladder.py:parse_rungs). The reference also sizes the
ladder from its committed memory ledger; here every requested rung is
served."""

from __future__ import annotations

__all__ = ["parse_rungs"]


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
