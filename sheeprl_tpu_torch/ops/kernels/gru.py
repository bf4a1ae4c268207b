"""LayerNorm-GRU cell: the port of `layernorm_gru_cell`
(sheeprl_tpu/ops/pallas_kernels.py:241, forward `_gru_forward`).

The CUDA kernel is `csrc/ln_gru.cu`. One deviation from the reference's
signature: the weight is in the port's Linear layout, [3H, Dx + H]
(out, in) — the transpose of the reference's [Dx + H, 3H] — so the
module's own parameter feeds the kernel without a copy per step.
"""

from __future__ import annotations

import ctypes

import torch

from .build import DTYPE_CODES, bind, reduction_splits

__all__ = ["layernorm_gru_cell", "layernorm_gru_cell_plain"]

# projection tile of csrc/ln_gru.cu: output columns x rows, reduction depth
_TILE_COLS, _TILE_ROWS, _TILE_DEPTH = 64, 16, 32
_P, _I = ctypes.c_void_p, ctypes.c_int
# ln_gru_forward(dtype, pointers..., sizes..., eps, stream)
_ARGTYPES = [_I, *[_P] * 7, _I, _I, _I, _I, ctypes.c_float, _P]
# the row pass keeps a 3H f32 row in shared memory (<= 227 KB on Hopper)
MAX_HIDDEN = 16384


def layernorm_gru_cell_plain(x, h, w, scale, offset, eps: float = 1e-5):
    """Plain PyTorch version: the math of the reference's `_gru_reference`
    with f32 accumulation and f32 gates (as the TPU kernel computes them),
    h' cast to x's dtype."""
    parts = torch.cat([x, h], dim=-1).float() @ w.float().t()
    mean = parts.mean(dim=-1, keepdim=True)
    centered = parts - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    parts = centered * torch.rsqrt(var + eps) * scale + offset
    r, c, u = parts.chunk(3, dim=-1)
    update = torch.sigmoid(u - 1.0)
    cand = torch.tanh(torch.sigmoid(r) * c)
    return (update * cand + (1.0 - update) * h.float()).to(x.dtype)


def _check(x, h, w, scale, offset) -> None:
    if x.dim() != 2 or h.dim() != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"x [B, Dx] and h [B, H] expected, got {tuple(x.shape)} and {tuple(h.shape)}")
    hidden = h.shape[1]
    if tuple(w.shape) != (3 * hidden, x.shape[1] + hidden):
        raise ValueError(
            f"w must be [3H, Dx + H] = {[3 * hidden, x.shape[1] + hidden]}, got {list(w.shape)}"
        )
    if tuple(scale.shape) != (3 * hidden,) or tuple(offset.shape) != (3 * hidden,):
        raise ValueError(f"scale/offset must be [{3 * hidden}]")
    if x.dtype not in DTYPE_CODES or h.dtype != x.dtype or w.dtype != x.dtype:
        raise TypeError(
            f"x, h, w must share one dtype in (float32, bfloat16), got {x.dtype}, {h.dtype}, {w.dtype}"
        )
    if scale.dtype != torch.float32 or offset.dtype != torch.float32:
        raise TypeError("scale/offset must be float32")
    if len({t.device for t in (x, h, w, scale, offset)}) != 1:
        raise ValueError("x, h, w, scale, offset must be on one device")
    if not all(t.is_contiguous() for t in (x, h, w, scale, offset)):
        raise ValueError("x, h, w, scale, offset must be contiguous")


def layernorm_gru_cell(x, h, w, scale, offset, eps: float = 1e-5):
    """Fused LayerNorm-GRU step: x [B, Dx], h [B, H], w [3H, Dx + H],
    scale/offset [3H] f32 -> h' [B, H] in x's dtype. CPU tensors take the
    plain version; CUDA tensors launch `csrc/ln_gru.cu`."""
    _check(x, h, w, scale, offset)
    if x.device.type == "cpu":
        return layernorm_gru_cell_plain(x, h, w, scale, offset, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_gru_cell runs on cpu or cuda tensors, got {x.device}")
    batch, hidden = h.shape
    if hidden > MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} exceeds the kernel's {MAX_HIDDEN}")
    k, n = x.shape[1] + hidden, 3 * hidden
    splits = reduction_splits(-(-n // _TILE_COLS) * -(-batch // _TILE_ROWS), k, _TILE_DEPTH)
    forward = bind("ln_gru", "ln_gru_forward", _ARGTYPES)
    parts = torch.empty((splits, batch, n), device=x.device, dtype=torch.float32)
    out = torch.empty_like(h)
    with torch.cuda.device(x.device):
        err = forward(
            DTYPE_CODES[x.dtype], x.data_ptr(), h.data_ptr(), w.data_ptr(),
            scale.data_ptr(), offset.data_ptr(), parts.data_ptr(), out.data_ptr(),
            batch, x.shape[1], hidden, splits, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ln_gru_forward launch failed: CUDA error {err}")
    layernorm_gru_cell.launches += 1
    return out


layernorm_gru_cell.launches = 0
