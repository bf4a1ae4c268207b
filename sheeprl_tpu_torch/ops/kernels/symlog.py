"""symlog and symexp: the port of `symlog` and `symexp`
(sheeprl_tpu/ops/pallas_kernels.py:750 and :767, both over `_elementwise`
at :740).

    symlog(x) = sign(x) * log1p(|x|)        d/dx = 1 / (1 + |x|)
    symexp(x) = sign(x) * (exp(|x|) - 1)    d/dx = exp(|x|)

The CUDA kernel is `csrc/symlog.cu`, one elementwise pass a call, for
float32 and bfloat16 (bf16 computes in f32 and rounds once): a scalar head
to 16-byte alignment of `x`, a body of 16-byte vectors walked by a
persistent grid, a scalar tail. `plan` is its launch plan, which the C side
checks against the pointers and the CPU tests sweep. Each function
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

__all__ = ["plan", "symexp", "symexp_plain", "symlog", "symlog_plain"]

# symlog_forward(fn, dtype, x, out, n, head, store_bytes, unroll, blocks, stream)
_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_FN_CODES = {"symlog": 0, "symexp": 1}
THREADS, UNROLL = 256, 4  # csrc/symlog.cu: kThreads, kUnroll (the most vectors a thread has in flight)
# the persistent grid's limit where the card was not asked: 8 blocks of 256
# threads on each of the H100's 132 SMs
DEFAULT_MAX_BLOCKS = 132 * 8
_max_blocks: dict[tuple[int, int], int] = {}


def plan(n: int, x_offset_bytes: int, dtype: torch.dtype, out_offset_bytes: int = 0,
         max_blocks: int = DEFAULT_MAX_BLOCKS) -> dict:
    """The launch of csrc/symlog.cu over `n` elements of `dtype` whose first
    element lies `x_offset_bytes` past a 16-byte boundary (`out`'s first at
    `out_offset_bytes`).

    `head` elements (fewer than one vector) take `x` to 16-byte alignment,
    then `vectors` 16-byte vectors of `vec_elems` elements, then `tail`
    elements (fewer than one vector). The body's stores go `store_bytes` at a
    time: 16 where `out` is aligned there too, else the largest power of two
    its address divides (the loads keep 16). `blocks` blocks of `threads`
    threads walk the body, a block taking `unroll` contiguous slabs of one
    vector a thread an iteration: vector j belongs to block
    (j // (threads * unroll)) % blocks, which meets it in iteration
    j // (threads * unroll * blocks). `unroll` is 4 (UNROLL) where the body
    gives every thread of the card's grid (`max_blocks`, occupancy x SMs)
    four vectors, else as many as it gives, at least 1; the grid is then
    one block per `threads * unroll` vectors, at most `max_blocks`."""
    item = torch.empty((), dtype=dtype).element_size()
    if n < 1 or x_offset_bytes % item or out_offset_bytes % item:
        raise ValueError(f"no plan for n={n} at offsets {x_offset_bytes}/{out_offset_bytes} of {item}-byte items")
    vec = 16 // item
    head = min(((16 - x_offset_bytes % 16) % 16) // item, n)
    vectors, tail = divmod(n - head, vec)
    off = (out_offset_bytes + head * item) % 16
    store_bytes = 16 if off == 0 else off & -off
    unroll = max(1, min(UNROLL, vectors // (max_blocks * THREADS)))
    per_block = THREADS * unroll
    blocks = max(1, min(max_blocks, -(-vectors // per_block)))
    return dict(item=item, vec_elems=vec, head=head, vectors=vectors, tail=tail, store_bytes=store_bytes,
                threads=THREADS, unroll=unroll, blocks=blocks,
                iterations=-(-vectors // (per_block * blocks)) if vectors else 0)


def _card_max_blocks(fn: str, dtype: torch.dtype) -> int:
    """Blocks an SM holds x SMs, asked of the card once per kernel."""
    key = (_FN_CODES[fn], DTYPE_CODES[dtype])
    if key not in _max_blocks:
        got = bind("symlog", "symlog_max_blocks", [ctypes.c_int, ctypes.c_int])(*key)
        if got <= 0:
            raise RuntimeError(f"symlog_max_blocks ({fn}, {dtype}) failed: {got}")
        _max_blocks[key] = got
    return _max_blocks[key]


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
        p = plan(x.numel(), x.data_ptr() % 16, x.dtype, out.data_ptr() % 16, _card_max_blocks(fn, x.dtype))
        err = forward(_FN_CODES[fn], DTYPE_CODES[x.dtype], x.data_ptr(), out.data_ptr(), x.numel(), p["head"],
                      p["store_bytes"], p["unroll"], p["blocks"], torch.cuda.current_stream(x.device).cuda_stream)
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
