"""Partition budgets (the port of sheeprl_tpu/compile/partition.py,
`partition_mem_budget_bytes` so far): the device-memory budget that one
partitioned step may peak at. The rest of the module (`decide_batch_chunk`,
`--split_update`, `--recon_chunk`, `ledger_entry`) comes with `sac_ae`
(ROADMAP Queue A item 7)."""

from __future__ import annotations

import os

__all__ = ["partition_mem_budget_bytes"]


def partition_mem_budget_bytes() -> int:
    """SHEEPRL_TPU_PARTITION_MEM_MB in bytes; 512 MiB when it is unset or
    not a number."""
    try:
        mb = float(os.environ.get("SHEEPRL_TPU_PARTITION_MEM_MB", "512"))
    except ValueError:
        mb = 512.0
    return int(mb * 2**20)
