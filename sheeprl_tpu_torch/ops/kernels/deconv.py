"""DreamerV3 decoder stage ConvTranspose2d(k4, s2, SAME) -> LayerNorm -> SiLU:
the port of `deconv_ln_silu` (sheeprl_tpu/ops/pallas_cnn.py:388): its
forward `_dec_call` (with and without residuals) and its backward
`_deconv_ln_silu_bwd`.

The CUDA kernel is `csrc/deconv_ln_silu.cu`: the four phases' implicit
GEMMs on the tensor cores and the LayerNorm -> SiLU pass of
`csrc/conv_common.cuh`, planned by `launch_plan`. Layouts are the reference's:
x [N, H, W, Cin] NHWC, k [4, 4, Cin, Cout] HWIO, y [N, 2H, 2W, Cout].

The transposed conv is the reference's subpixel form (`_subpixel_k4s2`,
`_dec_deconv`): `lax.conv_transpose` with `transpose_kernel=False`,
regrouped into four 2x2 phase kernels K[a, b, (dh, dw)] = k[2a+dh, 2b+dw]
over the input padded by one pixel, then interleaved. `F.conv_transpose2d`
with the HWIO kernel permuted is another function (flipped taps, another
padding rule), so the plain version here is the phase regrouping itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .build import DTYPE_CODES
from .cnn import gemm_plan, launch_stage, ln_silu_backward, ln_stats

__all__ = [
    "deconv_ln_silu", "deconv_ln_silu_plain", "deconv_ln_silu_residuals",
    "deconv_ln_silu_residuals_plain", "launch_plan", "phase_kernel", "subpixel_deconv",
]


def launch_plan(n: int, h: int, w: int, cin: int, cout: int, itemsize: int) -> dict:
    """`cnn.gemm_plan` of the decoder stage x [n, h, w, cin] -> [n, 2h, 2w,
    cout]: four phase products of n * h * w pixels, K = 4 cin."""
    return gemm_plan(n * h * w, 4 * cin, cout, itemsize, phases=4)


def phase_kernel(k: torch.Tensor) -> torch.Tensor:
    """[4, 4, Cin, Cout] HWIO -> the dense 2x2 phase kernel as an OIHW conv
    weight [4*Cout, Cin, 2, 2], output channels ordered (dh, dw, co): the
    reference's `_dec_wmat` regrouping."""
    cin, cout = k.shape[2], k.shape[3]
    kk = k.reshape(2, 2, 2, 2, cin, cout).permute(0, 2, 4, 1, 3, 5)  # [a, b, cin, dh, dw, cout]
    return kk.reshape(2, 2, cin, 4 * cout).permute(3, 2, 0, 1)


def _phase_kernel_grad(dkk: torch.Tensor) -> torch.Tensor:
    """The inverse regrouping: a gradient wrt the phase kernel [4*Cout, Cin,
    2, 2] -> the gradient wrt the HWIO kernel [4, 4, Cin, Cout]."""
    cin, cout = dkk.shape[1], dkk.shape[0] // 4
    g = dkk.permute(2, 3, 1, 0).reshape(2, 2, cin, 2, 2, cout)  # [a, b, cin, dh, dw, cout]
    return g.permute(0, 3, 1, 4, 2, 5).reshape(4, 4, cin, cout)


def _interleave(ph: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[N, h+1, w+1, 2, 2, C] phase outputs -> [N, 2h, 2w, C]: output pixel
    (2i+dh, 2j+dw) is phase (dh, dw) at (i+dh, j+dw)."""
    n, c = ph.shape[0], ph.shape[-1]
    row0 = torch.stack([ph[:, :h, :w, 0, 0], ph[:, :h, 1:, 0, 1]], dim=3)
    row1 = torch.stack([ph[:, 1:, :w, 1, 0], ph[:, 1:, 1:, 1, 1]], dim=3)
    return torch.stack([row0, row1], dim=2).reshape(n, 2 * h, 2 * w, c)


def subpixel_deconv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The bare k4/s2/SAME transposed conv (the reference's `_dec_deconv`),
    NHWC in x's dtype."""
    n, h, w, _ = x.shape
    cout = k.shape[3]
    ph = F.conv2d(x.permute(0, 3, 1, 2), phase_kernel(k.to(x.dtype)), padding=1)
    return _interleave(ph.permute(0, 2, 3, 1).reshape(n, h + 1, w + 1, 2, 2, cout), h, w)


def deconv_ln_silu_plain(x, k, scale, offset, eps: float = 1e-3):
    """Plain PyTorch version: the subpixel deconv in f32, the LayerNorm of
    `ln_stats`, SiLU; the result in x's dtype, NHWC-contiguous."""
    return deconv_ln_silu_residuals_plain(x, k, scale, offset, eps)[0]


def deconv_ln_silu_residuals_plain(x, k, scale, offset, eps: float = 1e-3):
    """Plain PyTorch version of the residual forward: (y, pre [N, 2H, 2W,
    Cout] f32)."""
    pre = subpixel_deconv(x.float(), k.float()).contiguous()
    y = F.silu(ln_stats(pre, eps)[0] * scale + offset)
    return y.to(x.dtype).contiguous(), pre


def _check(x, k, scale, offset) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, Cin], got {tuple(x.shape)}")
    if k.dim() != 4 or tuple(k.shape[:3]) != (4, 4, x.shape[3]):
        raise ValueError(f"k must be [4, 4, {x.shape[3]}, Cout], got {tuple(k.shape)}")
    cout = k.shape[3]
    if tuple(scale.shape) != (cout,) or tuple(offset.shape) != (cout,):
        raise ValueError(f"scale/offset must be [{cout}]")
    if x.dtype not in DTYPE_CODES or k.dtype != x.dtype:
        raise TypeError(f"x and k must share one dtype in (float32, bfloat16), got {x.dtype}, {k.dtype}")
    if scale.dtype != torch.float32 or offset.dtype != torch.float32:
        raise TypeError("scale/offset must be float32")
    if len({t.device for t in (x, k, scale, offset)}) != 1:
        raise ValueError("x, k, scale, offset must be on one device")
    if not all(t.is_contiguous() for t in (x, k, scale, offset)):
        raise ValueError("x, k, scale, offset must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deconv_ln_silu runs on cpu or cuda tensors, got {x.device}")


def _launch(x, k, scale, offset, eps, residuals: bool):
    """One call of csrc/deconv_ln_silu.cu -> y, or (y, pre) with residuals."""
    n, h, w, cin = x.shape
    cout = k.shape[3]
    plan = launch_plan(n, h, w, cin, cout, x.element_size())
    out = launch_stage("deconv_ln_silu", x, k, scale, offset, eps, residuals, plan, 4 * n * h * w,
                       (n, 2 * h, 2 * w, cout))
    deconv_ln_silu.launches += 1
    return out


def deconv_ln_silu_residuals(x, k, scale, offset, eps: float = 1e-3):
    """The forward with residuals: (y, pre f32). CPU tensors take the plain
    version; CUDA tensors launch `csrc/deconv_ln_silu.cu` with its residual
    output."""
    _check(x, k, scale, offset)
    if x.device.type == "cpu":
        return deconv_ln_silu_residuals_plain(x, k, scale, offset, eps)
    return _launch(x, k, scale, offset, eps, residuals=True)


class _DeconvLnSilu(torch.autograd.Function):
    """Residual forward + the reference's `_deconv_ln_silu_bwd`: the
    LayerNorm/SiLU backward from `pre`, then the subpixel deconv's VJP (the
    interleave's adjoint scatters the gradient back to the four phases, and
    the dense 2x2 conv's input and weight gradients follow)."""

    @staticmethod
    def forward(ctx, x, k, scale, offset, eps):
        y, pre = deconv_ln_silu_residuals(x, k, scale, offset, eps)
        ctx.save_for_backward(x, k, scale, offset, pre)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, k, scale, offset, pre = ctx.saved_tensors
        dpre, dscale, doffset = ln_silu_backward(dy, pre, scale, offset, ctx.eps)
        n, h, w, cin = x.shape
        cout = k.shape[3]
        g = dpre.to(x.dtype)
        dph = g.new_zeros((n, h + 1, w + 1, 2, 2, cout))
        dph[:, :h, :w, 0, 0] = g[:, 0::2, 0::2]
        dph[:, :h, 1:, 0, 1] = g[:, 0::2, 1::2]
        dph[:, 1:, :w, 1, 0] = g[:, 1::2, 0::2]
        dph[:, 1:, 1:, 1, 1] = g[:, 1::2, 1::2]
        dph = dph.reshape(n, h + 1, w + 1, 4 * cout).permute(0, 3, 1, 2)
        kk = phase_kernel(k.to(x.dtype))
        x_nchw = x.permute(0, 3, 1, 2)
        dx = dk = None
        needs = ctx.needs_input_grad
        if needs[0]:
            dx = torch.nn.grad.conv2d_input(x_nchw.shape, kk, dph, padding=1)
            dx = dx.permute(0, 2, 3, 1).contiguous()
        if needs[1]:
            dkk = torch.nn.grad.conv2d_weight(x_nchw, kk.shape, dph, padding=1)
            dk = _phase_kernel_grad(dkk).contiguous().to(k.dtype)
        return dx, dk, dscale, doffset, None


def deconv_ln_silu(x, k, scale, offset, eps: float = 1e-3):
    """Fused Dreamer decoder stage. When autograd needs a gradient the stage
    runs through `_DeconvLnSilu` (residual forward); otherwise CPU tensors
    take the plain version and CUDA tensors launch the plain forward of
    `csrc/deconv_ln_silu.cu`."""
    _check(x, k, scale, offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, k, scale, offset)):
        return _DeconvLnSilu.apply(x, k, scale, offset, eps)
    if x.device.type == "cpu":
        return deconv_ln_silu_plain(x, k, scale, offset, eps)
    return _launch(x, k, scale, offset, eps, residuals=False)


deconv_ln_silu.launches = 0
