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

`launch_plan` is the kernel's launch: a cluster of eight blocks for each
16-row tile, each layer's 8-column tiles (and, for a long reduction, its
splits of K) dealt to the cluster's warps, and where the three layers'
int8 images live. `mma_emulate` follows the kernel's products lane by lane:
the bytes each lane loads, the registers it hands to
`mma.sync.m16n8k32.s32.s8.s8.s32`, that instruction's fragment layout, and
the wrapping sum of the splits.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import int8_linear
from .build import bind

__all__ = ["fused_int8_trunk", "fused_int8_trunk_supported", "int8_trunk_reference", "launch_plan", "mma_emulate"]

# the reference's guard (pallas_kernels.py:327, 630-635): the quantized
# weights, scales and biases must fit 10 MiB
_FUSED_VMEM_BUDGET_BYTES = 10 * 1024 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int
# fused_int8_trunk_forward(x, s0, w0, ws0, b0, s1, w1, ws1, b1, sm, wm, wsm, bm,
#                          out, scratch, B, Dx, H0, H1, A, cluster, warps, splits0, splits1, splits2, stream)
_ARGTYPES = [_P] * 15 + [_I] * 10 + [_P]
# csrc/int8_trunk.cu's launch: blocks a cluster (where the clusters of all
# row tiles fit an H100's SMs at once, else 1), an H100's SMs, rows a tile
# (mma.sync's m16), bytes of K a k-block (two m16n8k32 products), weight
# k-blocks in flight a block (a 64 KB cp.async ring), the k-blocks of the
# three layers past which a block takes 16 warps rather than 8, the most
# k-blocks one product chain takes (2^17 products of |x_q| <= 127 and |w_q|
# <= 128 sum below 2^31, so no chain overflows; splits are added with
# wrapping int32 adds), the fewest k-blocks worth a split of their own, and
# the dynamic shared memory a block may have beside the kernel's static bytes
_CLUSTER, _SMS, _ROWS, _KB, _RING_BLOCKS, _WIDE_BLOCKS = 8, 132, 16, 64, 128, 1024
_CHUNK_BLOCKS, _MIN_SPLIT_BLOCKS = 2048, 16
_RING = _RING_BLOCKS * 8 * _KB
_SMEM_LIMIT = 232448 - 1024


def launch_plan(batch: int, dx: int, h0: int, h1: int, a: int) -> dict:
    """The launch of csrc/int8_trunk.cu for x [batch, dx] through dx -> h0
    -> h1 -> a.

    One cluster of `cluster` blocks a 16-row tile (`grid` blocks in all):
    eight, so that a serving batch's layers run on eight SMs, or one where
    the eight-block clusters of all row tiles would not fit the card at once.
    A block has `warps` warps: 16 where it has the layers to itself or they
    hold more than `_WIDE_BLOCKS` k-blocks (8-column tiles times 64-byte
    blocks of K), else 8.
    Per layer: `tiles` 8-column tiles, `k_blocks` 64-byte blocks of K cut
    into `splits` of `k_blocks_per_split` (none empty, none past
    `_CHUNK_BLOCKS`; a split of its own only where each has at least
    `_MIN_SPLIT_BLOCKS` and the tiles leave warps idle), the (tile, split)
    items dealt round-robin to the cluster's warps; split partials go to the
    tile's owner rank (`partial_bytes` a block). The int8 image of each
    layer's input, 16 rows of `stride` bytes (64 past a multiple of 128, so
    a quarter-warp's 16-byte reads hit every bank once), is held by every
    rank in shared memory where the three fit beside the weight ring
    (`smem`), else once a cluster in a device-memory scratch of
    `scratch_bytes`."""
    row_tiles = -(-batch // _ROWS)
    cluster = _CLUSTER if row_tiles * _CLUSTER <= _SMS else 1
    dims = ((dx, h0), (h0, h1), (h1, a))
    blocks = sum(-(-n // 8) * -(-k // _KB) for k, n in dims)
    warps = 16 if cluster == 1 or blocks > _WIDE_BLOCKS else 8
    layers = []
    for k, n in dims:
        tiles, kb = -(-n // 8), -(-k // _KB)
        splits = max(min(cluster * warps // tiles, kb // _MIN_SPLIT_BLOCKS), -(-kb // _CHUNK_BLOCKS), 1)
        kps = -(-kb // splits)
        stride = kb * _KB + (64 if kb % 2 == 0 else 0)
        layers.append(dict(k=k, n=n, tiles=tiles, k_blocks=kb, splits=-(-kb // kps), k_blocks_per_split=kps,
                           stride=stride))
    partial = max((-(-l["tiles"] // cluster) * l["splits"] * _ROWS * 8 * 4 for l in layers if l["splits"] > 1),
                  default=0)
    images = _ROWS * sum(l["stride"] for l in layers)
    fit = _RING + partial + images <= _SMEM_LIMIT
    return dict(cluster=cluster, warps=warps, row_tiles=row_tiles, grid=cluster * row_tiles, layers=layers,
                ring_bytes=_RING, partial_bytes=partial, image_bytes=images,
                smem=_RING + partial + (images if fit else 0), scratch_bytes=0 if fit else row_tiles * images)


def mma_emulate(x_q: torch.Tensor, w_q: torch.Tensor, k_blocks_per_split: int) -> torch.Tensor:
    """x_q [M, K] @ w_q[N, K]^T as int32, as csrc/int8_trunk.cu takes it.

    For each 16-row tile, 8-column tile and 64-byte k-block, lane (g, t) =
    (lane / 4, lane % 4) loads bytes [16t, 16t + 16) of the block's rows g
    and g + 8 of x_q and of row g of the w_q tile, as four words each; MMA s
    (0, 1) takes A = {row g word 2s, row g+8 word 2s, row g word 2s+1, row
    g+8 word 2s+1} and B = {word 2s, word 2s+1}. The PTX fragment layout of
    m16n8k32 .s8 then reads A register i as row g (+8 for i = 1, 3), columns
    4t .. 4t+3 (+16 for i = 2, 3), and B register i as rows 4t .. 4t+3 (+16
    for i = 1), column g. MMA s accumulates into chain s: each split's two
    chains are summed in k-block order and checked to stay inside int32 at
    every step, as the MMA's must; the chains and then the splits are added
    with wrapping int32 adds. Lane (g, t)'s accumulators c0 .. c3 (rows g,
    g+8; columns 2t, 2t+1) land where the epilogue writes them."""
    m, k = x_q.shape
    n = w_q.shape[0]
    kb = -(-k // _KB)
    rt, ct = -(-m // _ROWS), -(-n // 8)
    xp = torch.zeros(rt * _ROWS, kb * _KB, dtype=torch.int64)
    wp = torch.zeros(ct * 8, kb * _KB, dtype=torch.int64)
    xp[:m, :k], wp[:n, :k] = x_q.long(), w_q.long()
    # what lane (g, t) loads: [tile, g, k-block, t, word, byte]
    x_lanes = xp.reshape(rt, _ROWS, kb, 4, 4, 4)
    w_lanes = wp.reshape(ct, 8, kb, 4, 4, 4)
    total = torch.zeros(rt, ct, _ROWS, 8, dtype=torch.int64)
    for s in (0, 1):
        a_regs = (x_lanes[:, :8, ..., 2 * s, :], x_lanes[:, 8:, ..., 2 * s, :],
                  x_lanes[:, :8, ..., 2 * s + 1, :], x_lanes[:, 8:, ..., 2 * s + 1, :])
        b_regs = (w_lanes[..., 2 * s, :], w_lanes[..., 2 * s + 1, :])
        a = torch.zeros(rt, kb, _ROWS, 32, dtype=torch.int64)  # the MMA's logical A and B
        for i, reg in enumerate(a_regs):  # reg [tile, g, k-block, t, byte] -> rows g (+8), cols 4t + byte (+16)
            a[:, :, 8 * (i % 2):8 * (i % 2) + 8, 16 * (i // 2):16 * (i // 2) + 16] = (
                reg.permute(0, 2, 1, 3, 4).reshape(rt, kb, 8, 16))
        b = torch.zeros(ct, kb, 32, 8, dtype=torch.int64)
        for i, reg in enumerate(b_regs):  # reg [tile, g, k-block, t, byte] -> rows 4t + byte (+16), col g
            b[:, :, 16 * i:16 * i + 16, :] = reg.permute(0, 2, 3, 4, 1).reshape(ct, kb, 16, 8)
        products = torch.einsum("rkij,ckjn->rckin", a, b)  # [row tile, col tile, k-block, 16, 8]
        for k0 in range(0, kb, k_blocks_per_split):
            chain = products[:, :, k0:k0 + k_blocks_per_split].cumsum(dim=2)
            if int(chain.abs().max()) >= 2 ** 31:
                raise OverflowError("a product chain leaves int32: the kernel's MMA would overflow")
            total = _wrap(total + chain[:, :, -1])
    # lane (g, t)'s c_i is (row g + 8 (i // 2), column 2t + i % 2) of its tile
    return total.permute(0, 2, 1, 3).reshape(rt * _ROWS, ct * 8)[:m, :n].to(torch.int32)


def _wrap(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 that two's-complement arithmetic leaves, as int64."""
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


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
    plan = launch_plan(batch, dx, h0, h1, a)
    out = torch.empty((batch, a), device=x.device, dtype=torch.float32)
    # where the three int8 images do not fit shared memory beside the weight
    # ring, each cluster keeps its rows' images in device memory
    need = plan["scratch_bytes"]
    scratch = torch.empty(need, device=x.device, dtype=torch.int8) if need else None
    forward = bind("int8_trunk", "fused_int8_trunk_forward", _ARGTYPES)
    with torch.cuda.device(x.device):
        err = forward(
            x.data_ptr(), *(t.data_ptr() for layer in layers for t in layer), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), batch, dx, h0, h1, a, plan["cluster"], plan["warps"],
            *(layer["splits"] for layer in plan["layers"]), torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_int8_trunk_forward launch failed: CUDA error {err}")
    fused_int8_trunk.launches += 1
    return out


fused_int8_trunk.launches = 0
