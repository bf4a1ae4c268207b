"""symlog and symexp: the port of `symlog` and `symexp`
(sheeprl_tpu/ops/pallas_kernels.py:750 and :767, both over `_elementwise`
at :740).

    symlog(x) = sign(x) * log1p(|x|)        d/dx = 1 / (1 + |x|)
    symexp(x) = sign(x) * (exp(|x|) - 1)    d/dx = exp(|x|)

The CUDA kernel is `csrc/symlog.cu`, one grid-stride elementwise pass, for
float32 and bfloat16 (bf16 computes in f32 and rounds once). Each function
runs under a `torch.autograd.Function` whose backward is the reference's
analytic formula in plain PyTorch (its custom VJPs are plain jnp, not
kernels), computed in f32 and rounded once to the input's dtype.

Nothing calls these, as in the reference: DreamerV3 takes the plain
`ops/math.py` versions on either side. The wrappers take the plain version
for CPU tensors and launch the kernel for CUDA tensors (or raise).
"""

from __future__ import annotations

import ctypes

import torch

from .build import DTYPE_CODES, bind

__all__ = ["symexp", "symexp_plain", "symlog", "symlog_plain"]

# symlog_forward(fn, dtype, x, out, n, stream)
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
_FN_CODES = {"symlog": 0, "symexp": 1}


def symlog_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (f32 inside, one rounding)."""
    xf = x.float()
    return (torch.sign(xf) * torch.log1p(xf.abs())).to(x.dtype)


def symexp_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (f32 inside, one rounding)."""
    xf = x.float()
    return (torch.sign(xf) * (torch.exp(xf.abs()) - 1.0)).to(x.dtype)


_PLAIN = {"symlog": symlog_plain, "symexp": symexp_plain}


def _forward(fn: str, x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{fn} takes float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return _PLAIN[fn](x)
    if x.device.type != "cuda":
        raise ValueError(f"{fn} runs on cpu or cuda tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{fn} needs a contiguous tensor")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    forward = bind("symlog", "symlog_forward", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = forward(_FN_CODES[fn], DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), x.numel(),
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"symlog_forward ({fn}) launch failed: CUDA error {err}")
    _WRAPPERS[fn].launches += 1
    return out


class _Symlog(torch.autograd.Function):
    """The kernel's forward + the reference's `_symlog_bwd`."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _forward("symlog", x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() / (1.0 + x.float().abs())).to(x.dtype)


class _Symexp(torch.autograd.Function):
    """The kernel's forward + the reference's `_symexp_bwd`."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _forward("symexp", x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (g.float() * torch.exp(x.float().abs())).to(x.dtype)


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log1p(|x|), differentiable with the analytic gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Symlog.apply(x)
    return _forward("symlog", x)


def symexp(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * (exp(|x|) - 1), differentiable with the analytic gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Symexp.apply(x)
    return _forward("symexp", x)


symlog.launches = 0
symexp.launches = 0
_WRAPPERS = {"symlog": symlog, "symexp": symexp}
