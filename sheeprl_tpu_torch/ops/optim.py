"""The gradient step of the port's trainers: optax's `clip_by_global_norm`
written by hand, then one `torch.optim` step (the reference chains
`optax.clip_by_global_norm` before `scale_by_adam`)."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["apply_gradients", "clip_by_global_norm", "global_norm"]


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
