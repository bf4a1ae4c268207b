"""The gradient step of the port's trainers: optax's `clip_by_global_norm`
written by hand, then one `torch.optim` step (the reference chains
`optax.clip_by_global_norm` before `scale_by_adam`).

On CUDA the trainers' Adams are `capturable` (`adam`): their step counts
live on the device, so a whole train step can be captured in a CUDA graph.
PyTorch refuses `capturable` on the CPU, so it follows the device, and
`load_optimizer_state` keeps it so when a state saved on the other device
is loaded."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["adam", "apply_gradients", "clip_by_global_norm", "global_norm", "load_optimizer_state"]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the L2 norm of all the leaves together."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float | None):
    """optax.clip_by_global_norm's rule, written by hand: `g / norm *
    max_norm` when norm >= max_norm, else g (no epsilon, unlike
    `clip_grad_norm_`). -> (clipped grads, the norm before clipping)."""
    norm = global_norm(grads)
    if max_norm is None or max_norm <= 0:
        return list(grads), norm
    clipped = norm >= max_norm
    return [torch.where(clipped, g / norm.to(g.dtype) * max_norm, g) for g in grads], norm


def apply_gradients(params: list[torch.Tensor], grads: Sequence[torch.Tensor], optimizer,
                    clip: float | None) -> torch.Tensor:
    """Clip, then one optimizer step. Returns the norm before clipping."""
    grads, norm = clip_by_global_norm(grads, clip)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return norm


def adam(params, lr, eps: float, device) -> torch.optim.Adam:
    """`torch.optim.Adam`, capturable where the parameters live on CUDA."""
    return torch.optim.Adam(params, lr=lr, eps=eps, capturable=torch.device(device).type == "cuda")


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """`optimizer.load_state_dict(state)` for a state saved on either
    device: the optimizer keeps its own `capturable`, and a capturable
    one's step counts go to its parameters' device."""
    capturable = [group.get("capturable", False) for group in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, flag in zip(optimizer.param_groups, capturable):
        group["capturable"] = flag
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(p.device if flag else "cpu", torch.float32)
