"""DreamerV3 encoder stage Conv2d(k4, s2, SAME) -> LayerNorm -> SiLU: the port
of `conv_ln_silu` (sheeprl_tpu/ops/pallas_cnn.py:236): its forward
`_enc_call`, its forward with residuals and its backward
`_conv_ln_silu_bwd`.

The CUDA kernel is `csrc/conv_ln_silu.cu`; one call computes either
forward (the f32 pre-activation is an optional output): an implicit GEMM
on the tensor cores, then a LayerNorm -> SiLU pass over any Cout
(`csrc/conv_common.cuh`), planned by `launch_plan`. Layouts are the
reference's: x [N, H, W, Cin] NHWC, w [4, 4, Cin, Cout] HWIO,
y [N, H/2, W/2, Cout].

`conv_ln_silu` is the entry point the modules call. When autograd needs
its gradient it runs through `_ConvLnSilu`, whose forward is the residual
forward and whose backward is the reference's: the LayerNorm/SiLU backward
from the saved pre-activation (statistics recomputed with the forward's own
formula), then the convolution's input and weight gradients.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import DTYPE_CODES, bind

__all__ = [
    "cnn_stage_supported", "conv_ln_silu", "conv_ln_silu_plain", "conv_ln_silu_residuals",
    "conv_ln_silu_residuals_plain", "gemm_plan", "launch_plan", "launch_stage", "ln_silu_backward", "ln_stats",
]

# csrc/conv_common.cuh: the cp.async ring's stages; K split until the grid
# holds two blocks per H100 SM, each split at least four stages deep
_STAGES, _TARGET_BLOCKS, _MIN_STAGES_PER_SPLIT = 4, 2 * 132, 4
_P, _I = ctypes.c_void_p, ctypes.c_int
# conv_ln_silu_forward(dtype, pointers..., sizes..., plan..., eps, stream)
_ARGTYPES = [_I, *[_P] * 7, *[_I] * 10, ctypes.c_float, _P]


def gemm_plan(pixels: int, k: int, cout: int, itemsize: int, phases: int = 1) -> dict:
    """The launch of csrc/conv_common.cuh's implicit GEMM for `phases`
    products [pixels, k] x [k, cout] in a dtype of `itemsize` bytes: warps
    along the pixels `wm` (a 128 x 64 tile, or 256 x 32 for Cout <= 32),
    the tile `bm` x `bn` and its reduction depth a stage `bk` (128 bytes,
    64 for the 256 x 32 tile), `splits` slices of K of `k_per_split` each
    (whole stages, none empty; split only where the tiles alone leave SMs
    idle), the ring's `stages`, the dynamic shared memory `smem` in bytes,
    the `grid`, and whether the LayerNorm -> SiLU is `fused` into the
    product's epilogue (one split, Cout <= bn)."""
    wm = 8 if cout <= 32 else 4
    bm, bn = 32 * wm, 32 * (8 // wm)
    elems = 16 // itemsize
    bk = (8 if wm == 4 else 4) * elems
    tiles = phases * -(-pixels // bm) * -(-cout // bn)
    ktiles = -(-k // bk)
    want = max(1, min(-(-_TARGET_BLOCKS // tiles), -(-ktiles // _MIN_STAGES_PER_SPLIT)))
    k_per_split = -(-ktiles // want) * bk
    splits = -(-k // k_per_split)
    smem = _STAGES * (bm * (bk + elems) + bk * (bn + 8)) * itemsize
    return dict(wm=wm, bm=bm, bn=bn, bk=bk, splits=splits, k_per_split=k_per_split, stages=_STAGES, smem=smem,
                grid=(-(-pixels // bm), -(-cout // bn), phases * splits), fused=splits == 1 and cout <= bn)


def launch_plan(n: int, h: int, w: int, cin: int, cout: int, itemsize: int) -> dict:
    """`gemm_plan` of the encoder stage x [n, h, w, cin] -> [n, h/2, w/2,
    cout]: pixels n * h/2 * w/2, K = 16 cin."""
    return gemm_plan(n * (h // 2) * (w // 2), 16 * cin, cout, itemsize)


def cnn_stage_supported(kernel_shape, stride, padding, has_norm: bool, act) -> bool:
    """Structural eligibility for the fused stage, the reference's guard
    (sheeprl_tpu/ops/pallas_cnn.py:73-83): the Dreamer k4/s2/SAME
    LayerNorm-SiLU miniblock exactly, at any channel count."""
    return (
        tuple(kernel_shape[:2]) == (4, 4)
        and tuple(stride) == (2, 2)
        and padding == "SAME"
        and has_norm
        and act == "silu"
    )


def ln_stats(pre: torch.Tensor, eps: float):
    """(hat, rstd) of a LayerNorm over the last axis, in the two-pass order
    of the reference's `_ln_stats`: the one definition the plain forwards
    and the backwards share."""
    mean = pre.mean(dim=-1, keepdim=True)
    centered = pre - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    return centered * rstd, rstd


def _ln_silu(pre, scale, offset, eps):
    return F.silu(ln_stats(pre, eps)[0] * scale + offset)


def ln_silu_backward(dy, pre, scale, offset, eps):
    """Gradient of SiLU(LayerNorm(pre)) wrt pre, scale and offset (the
    reference's `_ln_silu_bwd`); statistics recomputed from `pre`."""
    dy = dy.float()
    hat, rstd = ln_stats(pre, eps)
    z = hat * scale + offset
    sig = torch.sigmoid(z)
    dz = dy * (sig * (1.0 + z * (1.0 - sig)))
    lead = tuple(range(dz.dim() - 1))
    dscale = (dz * hat).sum(dim=lead)
    doffset = dz.sum(dim=lead)
    g = dz * scale
    dpre = rstd * (g - g.mean(dim=-1, keepdim=True) - hat * (g * hat).mean(dim=-1, keepdim=True))
    return dpre, dscale, doffset


def _conv_pre(x, w):
    """The bare conv in f32: SAME padding is one pixel each side for k4/s2
    on even sizes. NHWC in and out."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), stride=2, padding=1)
    return y.permute(0, 2, 3, 1)


def conv_ln_silu_plain(x, w, scale, offset, eps: float = 1e-3):
    """Plain PyTorch version: F.conv2d, the LayerNorm of `ln_stats`, SiLU —
    in f32, the result cast to x's dtype, NHWC-contiguous."""
    return _ln_silu(_conv_pre(x, w), scale, offset, eps).to(x.dtype).contiguous()


def conv_ln_silu_residuals_plain(x, w, scale, offset, eps: float = 1e-3):
    """Plain PyTorch version of the residual forward: (y, pre [N, H/2,
    W/2, Cout] f32)."""
    pre = _conv_pre(x, w).contiguous()
    return _ln_silu(pre, scale, offset, eps).to(x.dtype).contiguous(), pre


def _check(x, w, scale, offset) -> None:
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"x must be [N, H, W, Cin] with even H and W, got {tuple(x.shape)}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (4, 4, x.shape[3]):
        raise ValueError(f"w must be [4, 4, {x.shape[3]}, Cout], got {tuple(w.shape)}")
    cout = w.shape[3]
    if tuple(scale.shape) != (cout,) or tuple(offset.shape) != (cout,):
        raise ValueError(f"scale/offset must be [{cout}]")
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share one dtype in (float32, bfloat16), got {x.dtype}, {w.dtype}")
    if scale.dtype != torch.float32 or offset.dtype != torch.float32:
        raise TypeError("scale/offset must be float32")
    if len({t.device for t in (x, w, scale, offset)}) != 1:
        raise ValueError("x, w, scale, offset must be on one device")
    if not all(t.is_contiguous() for t in (x, w, scale, offset)):
        raise ValueError("x, w, scale, offset must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv_ln_silu runs on cpu or cuda tensors, got {x.device}")


def launch_stage(name: str, x, w, scale, offset, eps, residuals: bool, plan: dict, out_pixels: int, out_shape):
    """One call of csrc/<name>.cu's forward with `plan` -> y, or (y, pre)
    with residuals. The f32 scratch of the split sums is allocated only
    where the pixel pass reads it and it is not the residual itself."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    forward = bind(name, f"{name}_forward", _ARGTYPES)
    splits = plan["splits"]
    direct = plan["fused"] or (residuals and splits == 1)
    scratch = None if direct else torch.empty((splits, out_pixels, cout), device=x.device, dtype=torch.float32)
    y = torch.empty(out_shape, device=x.device, dtype=x.dtype)
    pre = torch.empty(out_shape, device=x.device, dtype=torch.float32) if residuals else None
    with torch.cuda.device(x.device):
        err = forward(
            DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), scale.data_ptr(), offset.data_ptr(),
            None if scratch is None else scratch.data_ptr(), y.data_ptr(),
            None if pre is None else pre.data_ptr(), n, h, wd, cin, cout, plan["wm"], splits,
            plan["k_per_split"], plan["stages"], plan["smem"], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}_forward launch failed: CUDA error {err}")
    return (y, pre) if residuals else y


def _launch(x, w, scale, offset, eps, residuals: bool):
    """One call of csrc/conv_ln_silu.cu -> y, or (y, pre) with residuals."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    plan = launch_plan(n, h, wd, cin, cout, x.element_size())
    pixels = n * (h // 2) * (wd // 2)
    return launch_stage("conv_ln_silu", x, w, scale, offset, eps, residuals, plan, pixels,
                        (n, h // 2, wd // 2, cout))


def conv_ln_silu_residuals(x, w, scale, offset, eps: float = 1e-3):
    """The forward with residuals: (y, pre f32). CPU tensors take the plain
    version; CUDA tensors launch `csrc/conv_ln_silu.cu` with its residual
    output."""
    _check(x, w, scale, offset)
    if x.device.type == "cpu":
        return conv_ln_silu_residuals_plain(x, w, scale, offset, eps)
    res = _launch(x, w, scale, offset, eps, residuals=True)
    conv_ln_silu_residuals.launches += 1
    return res


conv_ln_silu_residuals.launches = 0


class _ConvLnSilu(torch.autograd.Function):
    """Residual forward + the reference's `_conv_ln_silu_bwd`."""

    @staticmethod
    def forward(ctx, x, w, scale, offset, eps):
        y, pre = conv_ln_silu_residuals(x, w, scale, offset, eps)
        ctx.save_for_backward(x, w, scale, offset, pre)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, scale, offset, pre = ctx.saved_tensors
        dpre, dscale, doffset = ln_silu_backward(dy, pre, scale, offset, ctx.eps)
        # the conv's VJP in x's dtype, as the reference's jax.vjp(_enc_conv)
        g = dpre.to(x.dtype).permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1)
        x_nchw = x.permute(0, 3, 1, 2)
        dx = dw = None
        needs = ctx.needs_input_grad
        if needs[0]:
            dx = torch.nn.grad.conv2d_input(x_nchw.shape, w_oihw, g, stride=2, padding=1)
            dx = dx.permute(0, 2, 3, 1).contiguous()
        if needs[1]:
            dw = torch.nn.grad.conv2d_weight(x_nchw, w_oihw.shape, g, stride=2, padding=1)
            dw = dw.permute(2, 3, 1, 0).contiguous().to(w.dtype)
        return dx, dw, dscale, doffset, None


def conv_ln_silu(x, w, scale, offset, eps: float = 1e-3):
    """Fused Dreamer encoder stage. When autograd needs a gradient the stage
    runs through `_ConvLnSilu` (residual forward); otherwise CPU tensors
    take the plain version and CUDA tensors launch the plain forward of
    `csrc/conv_ln_silu.cu`."""
    _check(x, w, scale, offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, scale, offset)):
        return _ConvLnSilu.apply(x, w, scale, offset, eps)
    if x.device.type == "cpu":
        return conv_ln_silu_plain(x, w, scale, offset, eps)
    y = _launch(x, w, scale, offset, eps, residuals=False)
    conv_ln_silu.launches += 1
    return y


conv_ln_silu.launches = 0
