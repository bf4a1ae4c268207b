"""The fused int8 SAC trunk: the port of `fused_int8_trunk`
(sheeprl_tpu/ops/pallas_kernels.py:597, its `pallas_call` at :613).

Three quantized linears with ReLU between them, the serving path of
`serve --algo sac --quant int8`:

    a0   = relu(int8_linear(x,  s0, w0, ws0, b0))     # trunk layer 0
    a1   = relu(int8_linear(a0, s1, w1, ws1, b1))     # trunk layer 1
    mean =      int8_linear(a1, sm, wm, wsm, bm)      # fc_mean head

(`ops/quant.py:int8_linear`). x [B, Dx] f32; per layer in_scale [in] f32,
w_q [out, in] int8 (the port's layout, the transpose of the reference's),
w_scale [out] f32 and bias [out] f32 -> mean [B, A] f32. The tanh squash
stays outside, as in the reference.

The CUDA kernel is `csrc/int8_trunk.cu`, one launch for the three layers.
It computes the plain version bit for bit: the integer product is exact on
both sides, and the f32 steps are the same IEEE operations in the same
order. `fused_int8_trunk` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (or raises). There is no gradient:
the reference has no VJP for this kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import int8_linear
from .build import bind

__all__ = ["fused_int8_trunk", "fused_int8_trunk_supported", "int8_trunk_reference"]

# the reference's guard (pallas_kernels.py:327, 630-635): the quantized
# weights, scales and biases must fit 10 MiB
_FUSED_VMEM_BUDGET_BYTES = 10 * 1024 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int
# fused_int8_trunk_forward(x, s0, w0, ws0, b0, s1, w1, ws1, b1, sm, wm, wsm, bm,
#                          out, scratch, B, Dx, H0, H1, A, stream)
_ARGTYPES = [_P] * 15 + [_I] * 5 + [_P]


def int8_trunk_reference(x, s0, w0, ws0, b0, s1, w1, ws1, b1, sm, wm, wsm, bm):
    """Plain PyTorch version of the kernel: the chain of `int8_linear`s."""
    a0 = torch.relu(int8_linear(x, s0, w0, ws0, b0))
    a1 = torch.relu(int8_linear(a0, s1, w1, ws1, b1))
    return int8_linear(a1, sm, wm, wsm, bm)


def fused_int8_trunk_supported(*weights) -> bool:
    """The reference's dispatch guard: the trunk's quantized weights,
    scales and biases total at most 10 MiB."""
    total = sum(w.numel() * w.element_size() for w in weights)
    return total <= _FUSED_VMEM_BUDGET_BYTES


def _check(x, layers) -> None:
    tensors = [x, *(t for layer in layers for t in layer)]
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be [B, D] float32, got {tuple(x.shape)} {x.dtype}")
    width = x.shape[1]
    for i, (s, w, ws, b) in enumerate(layers):
        if w.dtype != torch.int8 or w.dim() != 2 or w.shape[1] != width:
            raise ValueError(f"layer {i}: w_q must be [out, {width}] int8, got {tuple(w.shape)} {w.dtype}")
        out = w.shape[0]
        for name, t, n in (("in_scale", s, width), ("w_scale", ws, out), ("bias", b, out)):
            if t.dtype != torch.float32 or tuple(t.shape) != (n,):
                raise ValueError(f"layer {i}: {name} must be [{n}] float32, got {tuple(t.shape)} {t.dtype}")
        width = out
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x and the trunk's tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x and the trunk's tensors must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_int8_trunk runs on cpu or cuda tensors, got {x.device}")


def fused_int8_trunk(x, s0, w0, ws0, b0, s1, w1, ws1, b1, sm, wm, wsm, bm):
    """One fused quantized SAC trunk step -> raw mean [B, A] f32 (before
    the squash). CPU tensors take the plain version; CUDA tensors launch
    `csrc/int8_trunk.cu`."""
    layers = ((s0, w0, ws0, b0), (s1, w1, ws1, b1), (sm, wm, wsm, bm))
    _check(x, layers)
    if x.device.type == "cpu":
        return int8_trunk_reference(x, s0, w0, ws0, b0, s1, w1, ws1, b1, sm, wm, wsm, bm)
    batch, dx = x.shape
    h0, h1, a = w0.shape[0], w1.shape[0], wm.shape[0]
    out = torch.empty((batch, a), device=x.device, dtype=torch.float32)
    # where the hidden layers' int8 images do not fit shared memory beside
    # the tiles, each block keeps its rows' images in device memory
    need = bind("int8_trunk", "fused_int8_trunk_scratch_bytes", [_I, _I, _I], ctypes.c_longlong)(batch, h0, h1)
    scratch = torch.empty(need, device=x.device, dtype=torch.int8) if need else None
    forward = bind("int8_trunk", "fused_int8_trunk_forward", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = forward(
            x.data_ptr(), *(t.data_ptr() for layer in layers for t in layer), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), batch, dx, h0, h1, a,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_int8_trunk_forward launch failed: CUDA error {err}")
    fused_int8_trunk.launches += 1
    return out


fused_int8_trunk.launches = 0
