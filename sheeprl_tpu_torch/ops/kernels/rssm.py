"""The fused RSSM dynamic step: the port of `fused_rssm_step`
(sheeprl_tpu/ops/pallas_kernels.py:472), whose forward is
`_fused_rssm_forward` (:427) and whose backward `_fused_rssm_bwd` (:511)
recomputes through the plain twin.

One step is the pre-MLP (Linear -> LayerNorm -> act), the LayerNorm-GRU and
the prior and posterior heads (Linear -> LayerNorm -> act -> Linear + b).
The CUDA kernel is `csrc/fused_rssm.cu`, one cooperative launch in four
grid-synced stages whose products run on the tensor cores (`mma.sync` in
bf16, 3xTF32 in f32, `csrc/mma_common.cuh`), each warp streaming its slice
of the weights through a ring of 16-byte `cp.async` copies; `launch_plan`
gives the shared tiles' strides, the shared memory they need, and whether
the step is wide: past 227 KB of staged tiles each stage builds its operand
once into an L2-resident scratch instead, so the kernel takes every width
the guard admits with shared memory fixed by the dtype. One
deviation from the reference's signature: the six weights are in the
port's Linear layout, [out, in] (the transpose of the reference's
[in, out]), so the modules' own parameters feed the kernel without a copy
per step.

`fused_rssm_step` is the entry point `RSSM.dynamic` calls, under the
reference's guard `fused_rssm_supported`. When autograd needs its gradient
it runs through `_FusedRSSM`, whose forward is the kernel and whose
backward recomputes the plain version and differentiates it, as the
reference's custom VJP does (the TPU package has no backward kernel).
"""

from __future__ import annotations

import ctypes

import torch

from ...nn.core import activation
from .build import DTYPE_CODES, bind

__all__ = [
    "ACT_CODES", "fused_rssm_step", "fused_rssm_step_plain", "fused_rssm_supported", "launch_plan",
]

# the weights of one step must fit the reference's VMEM budget
# (pallas_kernels.py:327); the guard counts every one of the 16 tensors
_FUSED_VMEM_BUDGET_BYTES = 10 * 1024 * 1024
# the activations with an in-kernel implementation (the reference's
# _KERNEL_ACTS), by the code csrc/fused_rssm.cu switches on
ACT_CODES = {"silu": 0, "relu": 1, "tanh": 2, "elu": 3, "gelu": 4, "identity": 5}
# the most shared memory a block may have on Hopper, of which the kernel's
# static `stats` (16 rows x 2 float2) takes 256 bytes
_SMEM_BYTES, _STATIC_BYTES = 227 * 1024, 16 * 2 * 8
# csrc/fused_rssm.cu's block: 16 rows, 16 warps with a ring of chunk slots
# of 512 bytes each (6 in bf16, 4 in f32), a unit's 8 x 2 partial 16 x 8
# f32 tiles (the operand tiles and the affines follow from the widths:
# launch_plan)
_ROWS, _RED_BYTES = 16, 8 * 2 * 16 * 8 * 4
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# fused_rssm_forward(dtype, act, 19 inputs, h_out, prior, post, scratch, a_wide,
#                    B, Dx, R, D, Hd, E, SD, lda, ldp, smem, 3 eps, stream)
_ARGTYPES = [_I, _I, *[_P] * 24, *[_I] * 10, _F, _F, _F, _P]
_MATS = (3, 6, 9, 12, 14, 17)  # positions of the six weight matrices among the 19 inputs


def _ln(x32, scale, offset, eps):
    """f32 LayerNorm over the trailing axis, the reference's `_ln`."""
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    return centered * torch.rsqrt(var + eps) * scale + offset


def _dot(a, w):
    """a [B, K] @ w[N, K]^T: operands in the compute dtype, f32 sums."""
    return a.float() @ w.float().t()


def fused_rssm_step_plain(x, h, emb, wm, sm, om, wg, sg, og, wt1, st1, ot1, wt2, bt2,
                          wr1, sr1, or1, wr2, br2, act="silu", eps=(1e-3, 1e-5, 1e-3)):
    """Plain PyTorch version, line by line the reference's `_rssm_step_math`:
    matrix operands in the input dtype, f32 accumulations, LayerNorms and
    gates; z, h', t1 and r1 rounded to the input dtype. -> (h' [B, R] in
    x's dtype, prior_raw [B, S*D] f32, post_raw [B, S*D] f32)."""
    act_fn = activation(act)
    mlp_eps, gru_eps, head_eps = eps
    dt = x.dtype

    # RecurrentModel.mlp: Linear -> LN -> act
    z = act_fn(_ln(_dot(x, wm), sm, om, mlp_eps)).to(dt)

    # LayerNorm-GRU
    parts = _ln(_dot(torch.cat([z, h], dim=-1), wg), sg, og, gru_eps)
    hidden = h.shape[-1]
    r = parts[:, :hidden]
    c = parts[:, hidden:2 * hidden]
    u = parts[:, 2 * hidden:]
    update = torch.sigmoid(u - 1.0)
    cand = torch.tanh(torch.sigmoid(r) * c)
    h_new = (update * cand + (1.0 - update) * h.float()).to(dt)

    # transition head (prior)
    t1 = act_fn(_ln(_dot(h_new, wt1), st1, ot1, head_eps)).to(dt)
    prior_raw = _dot(t1, wt2) + bt2

    # representation head (posterior) over [h', emb]
    r1 = act_fn(_ln(_dot(torch.cat([h_new, emb], dim=-1), wr1), sr1, or1, head_eps)).to(dt)
    post_raw = _dot(r1, wr2) + br2
    return h_new, prior_raw, post_raw


def fused_rssm_supported(act: str, *weights) -> bool:
    """The reference's dispatch guard: an in-kernel activation, and the
    step's 16 weight tensors (the matrices in the compute dtype, the LN
    affines and head biases in f32) within the 10 MiB budget."""
    if act not in ACT_CODES:
        return False
    total = sum(w.numel() * w.element_size() for w in weights)
    return total <= _FUSED_VMEM_BUDGET_BYTES


def _check(tensors, act: str) -> None:
    x, h, emb, wm, sm, om, wg, sg, og, wt1, st1, ot1, wt2, bt2, wr1, sr1, or1, wr2, br2 = tensors
    if act not in ACT_CODES:
        raise ValueError(f"activation {act!r} has no in-kernel form; known: {sorted(ACT_CODES)}")
    if x.dim() != 2 or h.dim() != 2 or emb.dim() != 2 or not x.shape[0] == h.shape[0] == emb.shape[0]:
        raise ValueError(f"x [B, Dx], h [B, R], emb [B, E] expected, got {[tuple(t.shape) for t in (x, h, emb)]}")
    dx, rec, e = x.shape[1], h.shape[1], emb.shape[1]
    d, hd, sd = wm.shape[0], wt1.shape[0], wt2.shape[0]
    want = {
        "wm": ((d, dx), wm), "sm": ((d,), sm), "om": ((d,), om),
        "wg": ((3 * rec, d + rec), wg), "sg": ((3 * rec,), sg), "og": ((3 * rec,), og),
        "wt1": ((hd, rec), wt1), "st1": ((hd,), st1), "ot1": ((hd,), ot1),
        "wt2": ((sd, hd), wt2), "bt2": ((sd,), bt2),
        "wr1": ((hd, rec + e), wr1), "sr1": ((hd,), sr1), "or1": ((hd,), or1),
        "wr2": ((sd, hd), wr2), "br2": ((sd,), br2),
    }
    for name, (shape, t) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    mats = [tensors[i] for i in (0, 1, 2, *_MATS)]
    if x.dtype not in DTYPE_CODES or any(t.dtype != x.dtype for t in mats):
        raise TypeError(
            "x, h, emb and the six weight matrices must share one dtype in (float32, bfloat16), "
            f"got {sorted({str(t.dtype) for t in mats})}"
        )
    vecs = [t for i, t in enumerate(tensors) if i >= 3 and i not in _MATS]
    if any(t.dtype != torch.float32 for t in vecs):
        raise TypeError("the LayerNorm scales and offsets and the head biases must be float32")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("every input of fused_rssm_step must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every input of fused_rssm_step must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_rssm_step runs on cpu or cuda tensors, got {x.device}")


def launch_plan(dx: int, rec: int, d: int, hd: int, e: int, itemsize: int) -> dict:
    """The shared tiles of csrc/fused_rssm.cu for one step's widths in a
    dtype of `itemsize` bytes. The operand tile A holds, per stage, [x],
    [z, h], [h', emb] or [t1, pad, r1], each segment zero-padded to whole
    chunks (4 lanes x 16 bytes of K: `chunk` elements); its row is a
    multiple of 16 bytes and 64 past a multiple of 128, so that the 16-byte
    fragment reads of rows g and g + 1 fall in distinct banks. The f32
    pre-activation tile P holds D, 3R or 2Hd floats a row, and V the
    widest stage's LayerNorm scales and offsets. Where those tiles would
    not fit beside the weight rings, the step is `wide`: the operand lives
    in a device scratch of rows of `lda` elements, and shared memory holds
    only the rings and the partial tiles, a constant of the dtype. -> lda
    (elements), ldp (floats), chunk, smem (dynamic bytes), wide."""
    chunk = 64 // itemsize

    def pad(n):
        return -(-n // chunk) * chunk

    row = max(pad(dx), pad(d + rec), pad(rec + e), 2 * pad(hd)) * itemsize
    row = -(-row // 64) * 64
    if row % 128 == 0:
        row += 64
    lda, ldp = row // itemsize, -(-max(d, 3 * rec, 2 * hd) // 4) * 4
    fixed = 16 * (6 if itemsize == 2 else 4) * 512 + _RED_BYTES
    staged = fixed + _ROWS * (lda * itemsize + ldp * 4) + 4 * max(2 * d, 6 * rec, 4 * hd)
    wide = staged + _STATIC_BYTES > _SMEM_BYTES
    return dict(lda=lda, ldp=ldp, chunk=chunk, smem=fixed if wide else staged, wide=wide)


def _launch(tensors, act: str, eps):
    """One cooperative launch of csrc/fused_rssm.cu -> (h', prior_raw, post_raw)."""
    x, h, emb, wm, _, _, _, _, _, wt1, _, _, wt2 = tensors[:13]
    batch, dx = x.shape
    rec, e = h.shape[1], emb.shape[1]
    d, hd, sd = wm.shape[0], wt1.shape[0], wt2.shape[0]
    plan = launch_plan(dx, rec, d, hd, e, x.element_size())
    forward = bind("fused_rssm", "fused_rssm_forward", _ARGTYPES)
    h_out = torch.empty_like(h)
    prior = torch.empty((batch, sd), device=x.device, dtype=torch.float32)
    post = torch.empty((batch, sd), device=x.device, dtype=torch.float32)
    scratch = torch.empty((batch * (d + 3 * rec + 2 * hd),), device=x.device, dtype=torch.float32)
    a_wide = None
    if plan["wide"]:
        a_wide = torch.empty((-(-batch // _ROWS) * _ROWS, plan["lda"]), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        err = forward(
            DTYPE_CODES[x.dtype], ACT_CODES[act], *(t.data_ptr() for t in tensors),
            h_out.data_ptr(), prior.data_ptr(), post.data_ptr(), scratch.data_ptr(),
            None if a_wide is None else a_wide.data_ptr(), batch, dx, rec, d, hd, e, sd, plan["lda"], plan["ldp"],
            plan["smem"], *(float(v) for v in eps), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_rssm_forward launch failed: CUDA error {err}")
    return h_out, prior, post


def _forward(tensors, act: str, eps):
    """The step without autograd: the plain version for CPU tensors, the
    kernel for CUDA tensors (counted)."""
    if tensors[0].device.type == "cpu":
        return fused_rssm_step_plain(*tensors, act, eps)
    out = _launch(tensors, act, eps)
    fused_rssm_step.launches += 1
    return out


class _FusedRSSM(torch.autograd.Function):
    """The kernel forward + the reference's backward: recompute the plain
    version under autograd and differentiate it (`_fused_rssm_bwd`)."""

    @staticmethod
    def forward(ctx, act, eps, *tensors):
        ctx.act, ctx.eps = act, eps
        ctx.save_for_backward(*tensors)
        return _forward(tensors, act, eps)

    @staticmethod
    def backward(ctx, g_h, g_prior, g_post):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            outs = fused_rssm_step_plain(*leaves, ctx.act, ctx.eps)
            grads = iter(torch.autograd.grad(
                outs, [t for t in leaves if t.requires_grad], (g_h, g_prior, g_post), allow_unused=True
            ))
        return (None, None, *[next(grads) if n else None for n in needs])


def fused_rssm_step(x, h, emb, wm, sm, om, wg, sg, og, wt1, st1, ot1, wt2, bt2,
                    wr1, sr1, or1, wr2, br2, act="silu", eps=(1e-3, 1e-5, 1e-3)):
    """One fused RSSM dynamic step. x [B, Dx] (posterior_flat ++ action),
    h [B, R], emb [B, E] and the six weights ([out, in]) in the compute
    dtype; the LN scales/offsets and head biases f32. `eps` is (mlp_eps,
    gru_eps, head_eps). -> (h' [B, R] compute dtype, prior_raw [B, S*D]
    f32, post_raw [B, S*D] f32), the raw pre-unimix logits. CPU tensors take
    the plain version; CUDA tensors launch csrc/fused_rssm.cu or raise."""
    tensors = (x, h, emb, wm, sm, om, wg, sg, og, wt1, st1, ot1, wt2, bt2, wr1, sr1, or1, wr2, br2)
    _check(tensors, act)
    eps = tuple(float(v) for v in eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedRSSM.apply(act, eps, *tensors)
    return _forward(tensors, act, eps)


fused_rssm_step.launches = 0
