"""LayerNorm-GRU cell: the port of `layernorm_gru_cell`
(sheeprl_tpu/ops/pallas_kernels.py:241): its forward `_gru_forward`, its
forward under autodiff `_gru_forward_with_residuals` and its backward
`_gru_bwd`.

The CUDA kernel is `csrc/ln_gru.cu`; one launch computes either forward
(the residual outputs are optional pointers). Its projection runs on the
tensor cores: a ring of four shared-memory stages filled by 16-byte
`cp.async` copies, `mma.sync` in bf16, or three TF32 products an operand
pair (3xTF32) in f32 (`csrc/mma_common.cuh`). `launch_plan` chooses the
tile rows and how far the reduction axis is split across the grid. One
deviation from the reference's signature: the weight is in the port's
Linear layout, [3H, Dx + H] (out, in) — the transpose of the reference's
[Dx + H, 3H] — so the module's own parameter feeds the kernel without a
copy per step.

`layernorm_gru_cell` is the entry point the modules call. When autograd
needs its gradient it runs through `_LayerNormGRU`, whose forward is the
residual forward and whose backward is the reference's analytic formula in
plain PyTorch (the TPU package has no backward kernel either).
"""

from __future__ import annotations

import ctypes

import torch

from .build import DTYPE_CODES, bind

__all__ = [
    "MAX_HIDDEN", "launch_plan", "layernorm_gru_cell", "layernorm_gru_cell_plain",
    "layernorm_gru_cell_residuals", "layernorm_gru_cell_residuals_plain",
]

# projection tile of csrc/ln_gru.cu: output columns a block, shared-memory
# stages, bytes of K a stage and row, and the padded row in shared memory
_TILE_COLS, _STAGES, _ROW_BYTES, _LD_BYTES = 128, 4, 128, 144
_SMS = 132  # an H100's streaming multiprocessors
_P, _I = ctypes.c_void_p, ctypes.c_int
# ln_gru_forward(dtype, pointers..., B, Dx, H, bm, splits, k_per_split, eps, stream)
_ARGTYPES = [_I, *[_P] * 9, *[_I] * 6, ctypes.c_float, _P]
# the row pass keeps a 3H f32 row in shared memory (<= 227 KB on Hopper)
MAX_HIDDEN = 16384


def launch_plan(batch: int, k: int, n: int, itemsize: int) -> dict:
    """The projection's launch of csrc/ln_gru.cu for x, h rows `batch`,
    reduction length k = Dx + H and n = 3H outputs in a dtype of `itemsize`
    bytes: tile rows `bm` (16 at B <= 16, else 64), `splits` slices of the
    reduction axis of `k_per_split` each (whole stages; the last may be
    short, none is empty) so that the grid fills the card, and the dynamic
    shared memory of the stage ring in bytes."""
    bm = 16 if batch <= 16 else 64
    depth = _ROW_BYTES // itemsize
    # split until the grid holds two blocks an SM in f32, one in bf16: a bf16
    # stage carries twice the K, so each block keeps as many stages
    blocks = -(-n // _TILE_COLS) * -(-batch // bm)
    want = max(1, min(-(-_SMS * itemsize // 2 // blocks), -(-k // depth)))
    k_per_split = -(-(-(-k // want)) // depth) * depth
    return dict(bm=bm, splits=-(-k // k_per_split), k_per_split=k_per_split,
                smem=_STAGES * (bm + _TILE_COLS) * _LD_BYTES)


def _gates(post: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    r, c, u = post.chunk(3, dim=-1)
    update = torch.sigmoid(u - 1.0)
    cand = torch.tanh(torch.sigmoid(r) * c)
    return update * cand + (1.0 - update) * h.float()


def _normalise(x, h, w, eps):
    parts = torch.cat([x, h], dim=-1).float() @ w.float().t()
    mean = parts.mean(dim=-1, keepdim=True)
    centered = parts - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return centered * rstd, rstd


def layernorm_gru_cell_plain(x, h, w, scale, offset, eps: float = 1e-5):
    """Plain PyTorch version: the math of the reference's `_gru_reference`
    with f32 accumulation and f32 gates (as the TPU kernel computes them),
    h' cast to x's dtype."""
    hat, _ = _normalise(x, h, w, eps)
    return _gates(hat * scale + offset, h).to(x.dtype)


def layernorm_gru_cell_residuals_plain(x, h, w, scale, offset, eps: float = 1e-5):
    """Plain PyTorch version of the residual forward
    (`_gru_kernel_with_residuals`): (h', hat [B, 3H] f32, rstd [B, 1] f32)."""
    hat, rstd = _normalise(x, h, w, eps)
    return _gates(hat * scale + offset, h).to(x.dtype), hat, rstd


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layernorm_gru_cell runs on cpu or cuda tensors, got {x.device}")


def _launch(x, h, w, scale, offset, eps, residuals: bool):
    """One launch of csrc/ln_gru.cu -> h', or (h', hat, rstd) with residuals."""
    batch, hidden = h.shape
    if hidden > MAX_HIDDEN:
        raise ValueError(f"hidden size {hidden} exceeds the kernel's {MAX_HIDDEN}")
    k, n = x.shape[1] + hidden, 3 * hidden
    plan = launch_plan(batch, k, n, x.element_size())
    forward = bind("ln_gru", "ln_gru_forward", _ARGTYPES)
    parts = torch.empty((plan["splits"], batch, n), device=x.device, dtype=torch.float32)
    out = torch.empty_like(h)
    hat = rstd = None
    if residuals:
        hat = torch.empty((batch, n), device=x.device, dtype=torch.float32)
        rstd = torch.empty((batch, 1), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = forward(
            DTYPE_CODES[x.dtype], x.data_ptr(), h.data_ptr(), w.data_ptr(),
            scale.data_ptr(), offset.data_ptr(), parts.data_ptr(), out.data_ptr(),
            None if hat is None else hat.data_ptr(), None if rstd is None else rstd.data_ptr(),
            batch, x.shape[1], hidden, plan["bm"], plan["splits"], plan["k_per_split"], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ln_gru_forward launch failed: CUDA error {err}")
    return (out, hat, rstd) if residuals else out


def layernorm_gru_cell_residuals(x, h, w, scale, offset, eps: float = 1e-5):
    """The forward under autodiff: (h', hat [B, 3H] f32, rstd [B, 1] f32).
    CPU tensors take the plain version; CUDA tensors launch
    `csrc/ln_gru.cu` with its residual outputs."""
    _check(x, h, w, scale, offset)
    if x.device.type == "cpu":
        return layernorm_gru_cell_residuals_plain(x, h, w, scale, offset, eps)
    res = _launch(x, h, w, scale, offset, eps, residuals=True)
    layernorm_gru_cell_residuals.launches += 1
    return res


layernorm_gru_cell_residuals.launches = 0


class _LayerNormGRU(torch.autograd.Function):
    """Residual forward + the reference's `_gru_bwd`: the gate and LN chain
    rules from the saved `hat`/`rstd`, then the two products dW and d[x, h].
    dW is skipped when the weight needs no gradient (imagination
    differentiates through x only)."""

    @staticmethod
    def forward(ctx, x, h, w, scale, offset, eps):
        out, hat, rstd = layernorm_gru_cell_residuals(x, h, w, scale, offset, eps)
        ctx.save_for_backward(x, h, w, scale, offset, hat, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, h, w, scale, offset, hat, rstd = ctx.saved_tensors
        g = g.float()
        h32 = h.float()
        r, c, u = (hat * scale + offset).chunk(3, dim=-1)
        sr = torch.sigmoid(r)
        cand = torch.tanh(sr * c)
        update = torch.sigmoid(u - 1.0)

        d_update = g * (cand - h32)
        d_pre = g * update * (1.0 - cand * cand)
        dpost = torch.cat(
            [d_pre * c * sr * (1.0 - sr), d_pre * sr, d_update * update * (1.0 - update)], dim=-1
        )
        dhat = dpost * scale
        m1 = dhat.mean(dim=-1, keepdim=True)
        m2 = (dhat * hat).mean(dim=-1, keepdim=True)
        dparts = rstd * (dhat - m1 - hat * m2)

        dx = dh = dw = dscale = doffset = None
        needs = ctx.needs_input_grad
        if needs[0] or needs[1]:
            dxh = dparts @ w.float()
            dx = dxh[:, : x.shape[-1]].to(x.dtype)
            dh = (dxh[:, x.shape[-1]:] + g * (1.0 - update)).to(h.dtype)
        if needs[2]:
            dw = (dparts.t() @ torch.cat([x, h], dim=-1).float()).to(w.dtype)
        if needs[3]:
            dscale = (dpost * hat).sum(dim=0)
        if needs[4]:
            doffset = dpost.sum(dim=0)
        return dx, dh, dw, dscale, doffset, None


def layernorm_gru_cell(x, h, w, scale, offset, eps: float = 1e-5):
    """Fused LayerNorm-GRU step: x [B, Dx], h [B, H], w [3H, Dx + H],
    scale/offset [3H] f32 -> h' [B, H] in x's dtype. When autograd needs a
    gradient the step runs through `_LayerNormGRU` (residual forward);
    otherwise CPU tensors take the plain version and CUDA tensors launch
    the plain forward of `csrc/ln_gru.cu`."""
    _check(x, h, w, scale, offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, h, w, scale, offset)):
        return _LayerNormGRU.apply(x, h, w, scale, offset, eps)
    if x.device.type == "cpu":
        return layernorm_gru_cell_plain(x, h, w, scale, offset, eps)
    out = _launch(x, h, w, scale, offset, eps, residuals=False)
    layernorm_gru_cell.launches += 1
    return out


layernorm_gru_cell.launches = 0
