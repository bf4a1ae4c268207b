"""The gradient step of the port's trainers: optax's `clip_by_global_norm`
written by hand, then one step of `Adam`, optax's `scale_by_adam` followed
by `scale(-lr)` written by hand (the reference chains
`optax.clip_by_global_norm` before `optax.adam`).

`Adam` keeps each parameter's update count as an f32 tensor on the
parameter's device, on the CPU as on the card: both devices run the same
arithmetic, and a whole train step can be captured in a CUDA graph without
a `capturable` flag. Its state keys are `torch.optim.Adam`'s (`step`,
`exp_avg`, `exp_avg_sq`), so a state saved with PyTorch's Adam loads
(`load_optimizer_state`)."""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["Adam", "adam", "apply_gradients", "clip_by_global_norm", "global_norm", "load_optimizer_state"]


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
                    clip: float | None, weight_decay: float = 0.0) -> torch.Tensor:
    """Clip, then add `weight_decay * p` to each gradient (optax's
    `add_decayed_weights`, between the clip and the Adam in DreamerV2's
    chain), then one optimizer step. Returns the norm before clipping."""
    grads, norm = clip_by_global_norm(grads, clip)
    for p, g in zip(params, grads):
        p.grad = g + weight_decay * p.detach() if weight_decay else g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return norm


class Adam(torch.optim.Optimizer):
    """optax's `adam(lr, b1, b2, eps)` (`scale_by_adam` with eps_root 0,
    then `scale(-lr)`, then `apply_updates`), in optax's order of
    operations, over every parameter with a gradient:

        mu = (1 - b1) * g + b1 * mu;   nu = (1 - b2) * g * g + b2 * nu
        count += 1
        u = (mu / (1 - b1 ** count)) / (sqrt(nu / (1 - b2 ** count)) + eps)
        p = p + u * -lr

    everything in f32 tensors, `b ** count` too. `lr` is a float or a
    device scalar (an annealed lr a graph reads at every replay); a
    checkpoint should hold a float. Multi-tensor `torch._foreach_*` ops, so a
    step launches a few kernels a parameter group, not a few a parameter."""

    def __init__(self, params, lr: float | torch.Tensor = 1e-3, betas: tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "betas": tuple(betas), "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            grads = [p.grad for p in params]
            steps = [self.state[p]["step"] for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            b1, b2 = group["betas"]
            # the moments: (1 - b) * g**order + b * moment
            new = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, new)
            new = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(new, 1.0 - b2)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, new)
            torch._foreach_add_(steps, 1.0)
            # the bias corrections 1 - b ** count, in f32
            bc1 = torch._foreach_pow(b1, steps)
            torch._foreach_neg_(bc1)
            torch._foreach_add_(bc1, 1.0)
            bc2 = torch._foreach_pow(b2, steps)
            torch._foreach_neg_(bc2)
            torch._foreach_add_(bc2, 1.0)
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            updates = torch._foreach_div(mus, bc1)
            torch._foreach_div_(updates, denom)
            lr = group["lr"]
            torch._foreach_mul_(updates, -lr if isinstance(lr, torch.Tensor) else -float(lr))
            torch._foreach_add_(params, updates)
        return None


def adam(params, lr: float | torch.Tensor, eps: float) -> Adam:
    """The trainers' Adam: optax's `adam(lr, eps=eps)` (`Adam`)."""
    return Adam(params, lr=lr, eps=eps)


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """`optimizer.load_state_dict(state)` for a state saved on either device,
    also by PyTorch's Adam: every step count becomes an f32 tensor on its
    parameter's device, and the param groups keep only the optimizer's own
    settings (a PyTorch Adam's `capturable`, `foreach`, ... are dropped)."""
    keys = [set(group) for group in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, own in zip(optimizer.param_groups, keys):
        for k in set(group) - own:
            del group[k]
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = torch.as_tensor(st["step"]).to(p.device, torch.float32)
