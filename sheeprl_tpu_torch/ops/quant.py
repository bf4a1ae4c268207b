"""int8 symmetric quantization for policy inference (the port of
sheeprl_tpu/ops/quant.py).

Scheme (W8A8, per channel, round to nearest even, f32 at every layer
boundary):

  - activations get a per-input-channel scale `in_scale[in]` from
    calibration (absmax over seeded batches / 127);
  - the activation scale is folded into the weight before the weight is
    quantized, so the forward never rescales activations per channel:

        w_eff[out, in] = w[out, in] * in_scale[in]
        w_scale[out]   = absmax(w_eff[out, :]) / 127
        w_q            = round(w_eff / w_scale)          # int8

  - forward: `x_q = clip(round(x / in_scale))`, then
    `y = (x_q @ w_q.T).to(f32) * w_scale + bias`, the product accumulated
    exactly in integers and dequantized to f32 at the layer's output.

Layout: `w_q` is [out, in], the port's `Linear` layout (the reference
keeps [in, out]; `interop.py` transposes). The dotted module paths are the
reference's field paths (`model.layers.0`, `fc_mean`, ...), so a
`quant_scales.npz` written by either package loads in the other.

Calibration records each Linear's per-input-channel absmax with forward
pre-hooks under `torch.inference_mode()`. `quantize_linears` then returns a
copy of the module with every calibrated `Linear` swapped for a
`QuantLinear`; the surrounding module (`SACActor`) keeps its class, so the
serve policy's step runs on the quantized copy unchanged.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch
import torch.nn as tnn

from ..nn.layers import Linear

__all__ = [
    "QuantLinear",
    "absmax_scale",
    "quantize",
    "int8_linear",
    "map_linears",
    "linear_paths",
    "calibrate",
    "calibrate_from_buffer",
    "quantize_linears",
    "save_scales",
    "load_scales",
    "scales_path",
]

# scales are floored so a dead channel (all-zero activations) quantizes to
# zeros instead of dividing by zero
_SCALE_FLOOR = 1e-8
_QMAX = 127.0


def absmax_scale(x: torch.Tensor, dim: int | tuple[int, ...]) -> torch.Tensor:
    """Per-channel symmetric scale: absmax over `dim` mapped to [-127, 127]."""
    return (x.float().abs().amax(dim=dim) / _QMAX).clamp_min(_SCALE_FLOOR)


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even symmetric int8 quantization (scale broadcasts):
    `jnp.round`'s rounding, then a float clip to +-127, then int8."""
    q = torch.round(x.float() / scale)
    return q.clamp(-_QMAX, _QMAX).to(torch.int8)


def int8_linear(x: torch.Tensor, in_scale: torch.Tensor, w_q: torch.Tensor,
                w_scale: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """The one int8 linear of the port's plain path: quantize the input per
    channel, contract int8 x int8 exactly, dequantize to f32.

    The product runs in float64, where every partial sum of int8 products
    is an integer below 2^53 (127^2 * in < 2^53) and so exact in any order,
    on either device; it then wraps to int32 as the reference's int32
    accumulator does. (`torch.matmul` has no integer kernel on CUDA, and an
    f32 product is exact only below 127^2 * in < 2^24.)"""
    x_q = quantize(x, in_scale)
    acc = (x_q.double() @ w_q.double().T).to(torch.int64).to(torch.int32)
    y = acc.float() * w_scale
    if bias is not None:
        y = y + bias.float()
    return y


class QuantLinear(tnn.Module):
    """Drop-in int8 replacement for `nn.layers.Linear`: buffers `w_q` int8
    [out, in] (activation scale folded in), `w_scale` f32 [out], `in_scale`
    f32 [in] and `bias` f32 [out] or None. The output is always f32."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor, in_scale: torch.Tensor,
                 bias: torch.Tensor | None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("in_scale", in_scale)
        self.register_buffer("bias", bias)

    @classmethod
    def from_linear(cls, linear: Linear, in_scale) -> "QuantLinear":
        w32 = linear.weight.detach().float()
        in_scale = torch.as_tensor(in_scale, dtype=torch.float32, device=w32.device)
        w_eff = w32 * in_scale[None, :]
        w_scale = absmax_scale(w_eff, dim=1)
        w_q = quantize(w_eff, w_scale[:, None])
        bias = None if linear.bias is None else linear.bias.detach().float().clone()
        return cls(w_q, w_scale, in_scale.clone(), bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_linear(x, self.in_scale, self.w_q, self.w_scale, self.bias)

    @property
    def in_features(self) -> int:
        return self.w_q.shape[1]

    @property
    def out_features(self) -> int:
        return self.w_q.shape[0]


# ---------------------------------------------------------------------------
# structural traversal: find/replace Linear layers anywhere in a module tree
# ---------------------------------------------------------------------------


def map_linears(module: tnn.Module, fn: Callable[[str, Linear], tnn.Module],
                path: str = "") -> tnn.Module:
    """`module` with every `Linear` at any depth replaced by
    `fn(dotted_path, linear)`. Modules on the way to a replaced Linear are
    shallow copies (their parameters and buffers shared with the original);
    the rest, and `module` itself when nothing changed, are the originals.
    Returning the linear itself from `fn` keeps it."""
    if isinstance(module, Linear):
        return fn(path, module)
    changes = {}
    for name, child in module.named_children():
        new = map_linears(child, fn, f"{path}.{name}" if path else name)
        if new is not child:
            changes[name] = new
    if not changes:
        return module
    clone = copy.copy(module)
    clone._parameters = dict(module._parameters)
    clone._buffers = dict(module._buffers)
    clone._modules = {**module._modules, **changes}
    return clone


def linear_paths(module: tnn.Module) -> list[str]:
    """Dotted paths of every Linear in the tree (calibration coverage)."""
    return [path for path, m in module.named_modules() if isinstance(m, Linear)]


# ---------------------------------------------------------------------------
# calibration: absmax recording with forward pre-hooks
# ---------------------------------------------------------------------------


def calibrate(module: tnn.Module, call: Callable[[tnn.Module, Any], Any],
              batches: Iterable[Any]) -> dict[str, np.ndarray]:
    """Run `call(module, batch)` over `batches` with every Linear's input
    recorded (per-input-channel absmax); return {dotted_path: f32 scale
    vector [in_features]} for every Linear the forward touched."""
    record: dict[str, np.ndarray] = {}

    def recorder(path: str):
        def hook(_mod, inputs):
            x = inputs[0]
            amax = x.float().abs().amax(dim=tuple(range(x.dim() - 1))).cpu().numpy()
            prev = record.get(path)
            record[path] = amax if prev is None else np.maximum(prev, amax)
        return hook

    handles = [m.register_forward_pre_hook(recorder(path))
               for path, m in module.named_modules() if isinstance(m, Linear)]
    try:
        with torch.inference_mode():
            for batch in batches:
                call(module, batch)
    finally:
        for h in handles:
            h.remove()
    return {
        path: np.maximum(amax, _SCALE_FLOOR * _QMAX).astype(np.float32) / _QMAX
        for path, amax in record.items()
    }


def calibrate_from_buffer(module: tnn.Module, call: Callable[[tnn.Module, Any], Any], buffer: Any, *,
                          obs_key: str = "obs", n_batches: int = 4, batch_size: int = 64) -> dict[str, np.ndarray]:
    """Calibration over the replay buffer's own sample path: `n_batches`
    uniform draws of `batch_size` rows (`buffer.sample`, e.g.
    `data/buffers.py:ReplayBuffer`), the `obs_key` column of each fed to
    `calibrate` as an f32 tensor on the column's device. The draws follow
    the buffer's seeded generator, so a buffer seeded alike gives the same
    scales."""
    batches = []
    for _ in range(n_batches):
        col = buffer.sample(batch_size)[obs_key]
        batches.append(col.float() if isinstance(col, torch.Tensor)
                       else torch.from_numpy(np.asarray(col, np.float32)))
    return calibrate(module, call, batches)


def quantize_linears(module: tnn.Module, scales: Mapping[str, Any]) -> tnn.Module:
    """Swap every calibrated Linear for its QuantLinear; Linears with no
    recorded scale (never touched by the calibration forward) stay f32."""

    def swap(path: str, lin: Linear) -> tnn.Module:
        s = scales.get(path)
        if s is None:
            return lin
        return QuantLinear.from_linear(lin, np.asarray(s, np.float32))

    return map_linears(module, swap)


# ---------------------------------------------------------------------------
# scale persistence (next to the checkpoint)
# ---------------------------------------------------------------------------


def scales_path(ckpt_path: str) -> str:
    """`quant_scales.npz` beside the checkpoint file/dir."""
    base = ckpt_path.rstrip("/")
    return os.path.join(os.path.dirname(base), "quant_scales.npz")


def save_scales(path: str, scales: Mapping[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in scales.items()})


def load_scales(path: str) -> dict[str, np.ndarray] | None:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
