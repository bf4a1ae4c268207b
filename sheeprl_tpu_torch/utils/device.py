"""Device resolution for the port's entry points: the CUDA device unless the
caller asks for the CPU, and never a quiet fall back from one to the other."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """`--device` value -> torch.device. Raises when a CUDA device is asked
    for (the default) and this process has none."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: CUDA is not available in this process; pass "
            "--device cpu to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be 'cuda[:N]' or 'cpu', got {name!r}")
    return device
