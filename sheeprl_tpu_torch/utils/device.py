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


def check_num_devices(num_devices: int, device: torch.device) -> int:
    """`--num_devices` against the devices of `device`'s kind this process
    sees (the cards, or the one CPU): a count beyond them raises as the
    reference's `local_mesh_devices` does. The port has no mesh yet, so a
    count above 1 raises `NotImplementedError`, and -1 (all) runs on the
    one device the run was given. -> the count of devices the run uses."""
    available = torch.cuda.device_count() if device.type == "cuda" else 1
    if num_devices > available:
        raise ValueError(f"requested {num_devices} devices but only {available} available")
    if num_devices > 1:
        raise NotImplementedError(
            f"--num_devices {num_devices}: the port runs on one device; a mesh of several comes with the "
            "decoupled mains and parallel/ (ROADMAP Queue A item 8)"
        )
    return 1
