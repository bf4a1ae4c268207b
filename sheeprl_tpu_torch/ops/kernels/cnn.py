"""DreamerV3 encoder stage Conv2d(k4, s2, SAME) -> LayerNorm -> SiLU: the port
of `conv_ln_silu` (sheeprl_tpu/ops/pallas_cnn.py:236, forward `_enc_call`).

The CUDA kernel is `csrc/conv_ln_silu.cu`. Layouts are the reference's:
x [N, H, W, Cin] NHWC, w [4, 4, Cin, Cout] HWIO, y [N, H/2, W/2, Cout].
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import DTYPE_CODES, bind, reduction_splits

__all__ = ["MAX_COUT", "cnn_stage_supported", "conv_ln_silu", "conv_ln_silu_plain"]

# the pixel pass of csrc/conv_ln_silu.cu holds Cout in one warp's registers
MAX_COUT = 512
# projection tile of csrc/conv_ln_silu.cu: channels x pixels, reduction depth
_TILE_COLS, _TILE_ROWS, _TILE_DEPTH = 64, 16, 32
_P, _I = ctypes.c_void_p, ctypes.c_int
# conv_ln_silu_forward(dtype, pointers..., sizes..., eps, stream)
_ARGTYPES = [_I, *[_P] * 6, *[_I] * 6, ctypes.c_float, _P]


def cnn_stage_supported(kernel_shape, stride, padding, has_norm: bool, act) -> bool:
    """Structural eligibility for the fused stage: the Dreamer k4/s2/SAME
    LayerNorm-SiLU miniblock with a Cout that one block holds."""
    return (
        tuple(kernel_shape[:2]) == (4, 4)
        and tuple(stride) == (2, 2)
        and padding == "SAME"
        and has_norm
        and act == "silu"
        and kernel_shape[3] <= MAX_COUT
    )


def conv_ln_silu_plain(x, w, scale, offset, eps: float = 1e-3):
    """Plain PyTorch version: F.conv2d with SAME padding (one pixel each
    side for k4/s2 on even sizes), F.layer_norm over channels, F.silu — in
    f32, the result cast to x's dtype, NHWC-contiguous."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), stride=2, padding=1)
    y = F.layer_norm(y.permute(0, 2, 3, 1), (w.shape[3],), scale, offset, eps)
    return F.silu(y).to(x.dtype).contiguous()


def _check(x, w, scale, offset) -> None:
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"x must be [N, H, W, Cin] with even H and W, got {tuple(x.shape)}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (4, 4, x.shape[3]):
        raise ValueError(f"w must be [4, 4, {x.shape[3]}, Cout], got {tuple(w.shape)}")
    cout = w.shape[3]
    if cout > MAX_COUT:
        raise ValueError(f"Cout {cout} exceeds the kernel's {MAX_COUT} channels")
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


def conv_ln_silu(x, w, scale, offset, eps: float = 1e-3):
    """Fused Dreamer encoder stage. CPU tensors take the plain version; CUDA
    tensors launch `csrc/conv_ln_silu.cu`."""
    _check(x, w, scale, offset)
    if x.device.type == "cpu":
        return conv_ln_silu_plain(x, w, scale, offset, eps)
    if x.device.type != "cuda":
        raise ValueError(f"conv_ln_silu runs on cpu or cuda tensors, got {x.device}")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    pixels = n * (h // 2) * (wd // 2)
    splits = reduction_splits(-(-cout // _TILE_COLS) * -(-pixels // _TILE_ROWS), 16 * cin, _TILE_DEPTH)
    forward = bind("conv_ln_silu", "conv_ln_silu_forward", _ARGTYPES)
    pre = torch.empty((splits, pixels, cout), device=x.device, dtype=torch.float32)
    y = torch.empty((n, h // 2, wd // 2, cout), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        err = forward(
            DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), scale.data_ptr(),
            offset.data_ptr(), pre.data_ptr(), y.data_ptr(), n, h, wd, cin, cout, splits,
            float(eps), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"conv_ln_silu_forward launch failed: CUDA error {err}")
    conv_ln_silu.launches += 1
    return y


conv_ln_silu.launches = 0
