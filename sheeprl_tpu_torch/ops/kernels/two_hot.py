"""Two-hot log-probability: the port of `two_hot_log_prob`
(sheeprl_tpu/ops/pallas_kernels.py:699): its forward `_two_hot_forward`
and its backward `_two_hot_bwd`.

The CUDA kernel is `csrc/two_hot.cu`. x [N, 1] f32 targets (already in
symlog space), logits [N, K], bins [1, K] f32 -> log-prob [N, 1] f32, at
any N and K >= 1. The gradient reaches the logits only, (two_hot(x) -
softmax(logits)) * g: the DreamerV3 losses treat the two-hot target as a
constant.

`launch_plan` is the kernel's launch: a persistent grid whose blocks walk
over units of the logits (runs of whole rows, or chunks of one row where a
row is too long for a stage) through a two-stage shared-memory ring.
`staging` is how each unit's bytes reach its stage: one bulk copy of the
16-byte-aligned body, element loads for the unaligned head and tail.
"""

from __future__ import annotations

import ctypes

import torch

from .build import DTYPE_CODES, bind

__all__ = ["launch_plan", "staging", "two_hot", "two_hot_log_prob", "two_hot_log_prob_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# two_hot_log_prob_forward(dtype, x, logits, bins, out, N, K, rows_per_run,
#                          chunk_cols, stage_bytes, blocks, stream)
_ARGTYPES = [_I, _P, _P, _P, _P, *[_I] * 6, _P]
# csrc/two_hot.cu's launch: threads a block, bytes a run of short rows aims
# at, the most rows a run holds (eight warps of four), the most one stage
# holds (a whole row, or a chunk of one with its bins), the header before
# the ring (two mbarriers and eight warps' parts of four rows), the shared
# memory a block may have, an H100's SMs, and the blocks an SM is given at
# most (the kernel's launch bounds)
_THREADS, _RUN_BYTES, _MAX_RUN_ROWS, _MAX_STAGE, _HEADER = 256, 32768, 32, 49152, 640
_SMEM_LIMIT, _SMS, _BLOCKS_PER_SM = 232448, 132, 3


def staging(address: int, nbytes: int) -> tuple[int, int, int]:
    """How `nbytes` bytes at global `address` reach shared memory: (head,
    body, tail) byte counts. The body, 16-byte aligned at both ends, goes by
    one bulk copy; the head and the tail (each under 16 bytes) by element
    loads. The image keeps the bytes' alignment within 16, so it needs
    `_image_bytes(nbytes)` bytes of shared memory at most."""
    end = address + nbytes
    head_end = min(-(-address // 16) * 16, end)
    tail_start = max(end // 16 * 16, head_end)
    return head_end - address, tail_start - head_end, end - tail_start


def _image_bytes(nbytes: int) -> int:
    return -(-nbytes // 16) * 16 + 16


def launch_plan(n: int, k: int, itemsize: int) -> dict:
    """The launch of csrc/two_hot.cu for logits [n, k] of `itemsize` bytes.

    A row whose image fits a stage is taken whole: a unit is a run of
    `rows_per_run` consecutive rows (at most 32, about 32 KB), its bins
    staged once a block. A longer row
    is cut into `chunks` chunks of `chunk_cols` columns, each staged with
    its slice of the bins. `stage_bytes` is one stage of the two-stage ring,
    `smem` the block's dynamic shared memory, `blocks` the persistent grid
    (at most three blocks an SM, every block walking as many runs)."""
    row = k * itemsize
    if _image_bytes(row) <= _MAX_STAGE:
        rows = max(1, min(_MAX_RUN_ROWS, _RUN_BYTES // row))
        cols, stage, bins = k, _image_bytes(rows * row), -(-4 * k // 16) * 16
    else:
        rows = 1
        cols = (_MAX_STAGE - 32) // (itemsize + 4) // 64 * 64
        stage, bins = _image_bytes(cols * itemsize) + _image_bytes(4 * cols), 0
    runs = -(-n // rows)
    smem = _HEADER + 2 * stage + bins
    per_sm = max(1, min(_BLOCKS_PER_SM, _SMEM_LIMIT // (smem + 1024)))
    blocks = min(runs, _SMS * per_sm)
    blocks = -(-runs // -(-runs // blocks))
    return dict(rows_per_run=rows, chunk_cols=cols, chunks=-(-k // cols), runs=runs, stage_bytes=stage,
                ring_bytes=2 * stage, bins_bytes=bins, smem=smem, blocks=blocks)


def _bracket(x: torch.Tensor, bins: torch.Tensor):
    """x [...], bins [K] -> (below, above, w_below, w_above): the bracketing
    bins by comparison counts, clipped to the edges, and the two
    interpolation weights (the reference's `two_hot` rule)."""
    k = bins.shape[0]
    below = (bins <= x[..., None]).sum(dim=-1) - 1
    above = k - (bins > x[..., None]).sum(dim=-1)
    below = below.clamp(0, k - 1)
    above = above.clamp(0, k - 1)
    equal = below == above
    one = torch.ones((), dtype=x.dtype, device=x.device)
    d_below = torch.where(equal, one, (bins[below] - x).abs())
    d_above = torch.where(equal, one, (bins[above] - x).abs())
    total = d_below + d_above
    return below, above, d_above / total, d_below / total


def two_hot(x: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Dense two-hot encoding: x [...] scalars, bins [K] -> [..., K] with
    the mass split between the two neighbouring bins (the port of
    sheeprl_tpu/ops/math.py:two_hot)."""
    below, above, w_below, w_above = _bracket(x, bins)
    k = bins.shape[0]
    one_hot = torch.nn.functional.one_hot
    return one_hot(below, k).to(x.dtype) * w_below[..., None] + one_hot(above, k).to(x.dtype) * w_above[..., None]


def two_hot_log_prob_plain(x, logits, bins):
    """Plain PyTorch version of the kernel: the two bracketing log-probs
    picked from the log-softmax row and mixed by the interpolation
    weights, without the dense [N, K] target."""
    below, above, w_below, w_above = _bracket(x[:, 0], bins[0])
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    lp_below = log_probs.gather(-1, below[:, None])[:, 0]
    lp_above = log_probs.gather(-1, above[:, None])[:, 0]
    return (w_below * lp_below + w_above * lp_above)[:, None]


def _check(x, logits, bins) -> None:
    if logits.dim() != 2 or tuple(x.shape) != (logits.shape[0], 1):
        raise ValueError(f"x [N, 1] and logits [N, K] expected, got {tuple(x.shape)} and {tuple(logits.shape)}")
    if tuple(bins.shape) != (1, logits.shape[1]):
        raise ValueError(f"bins must be [1, {logits.shape[1]}], got {tuple(bins.shape)}")
    if x.dtype != torch.float32 or bins.dtype != torch.float32 or logits.dtype not in DTYPE_CODES:
        raise TypeError(
            f"x and bins must be float32 and logits float32 or bfloat16, got {x.dtype}, {bins.dtype}, {logits.dtype}"
        )
    if len({t.device for t in (x, logits, bins)}) != 1:
        raise ValueError("x, logits, bins must be on one device")
    if not all(t.is_contiguous() for t in (x, logits, bins)):
        raise ValueError("x, logits, bins must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"two_hot_log_prob runs on cpu or cuda tensors, got {x.device}")


def _forward(x, logits, bins):
    """CPU tensors take the plain version; CUDA tensors launch
    `csrc/two_hot.cu`."""
    if x.device.type == "cpu":
        return two_hot_log_prob_plain(x, logits, bins)
    n, k = logits.shape
    plan = launch_plan(n, k, logits.element_size())
    forward = bind("two_hot", "two_hot_log_prob_forward", _ARGTYPES)
    out = torch.empty((n, 1), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        err = forward(
            DTYPE_CODES[logits.dtype], x.data_ptr(), logits.data_ptr(), bins.data_ptr(),
            out.data_ptr(), n, k, plan["rows_per_run"], plan["chunk_cols"], plan["stage_bytes"],
            plan["blocks"], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"two_hot_log_prob_forward launch failed: CUDA error {err}")
    two_hot_log_prob.launches += 1
    return out


class _TwoHotLogProb(torch.autograd.Function):
    """The kernel's forward + the reference's `_two_hot_bwd`."""

    @staticmethod
    def forward(ctx, x, logits, bins):
        ctx.save_for_backward(x, logits, bins)
        return _forward(x, logits, bins)

    @staticmethod
    def backward(ctx, g):
        x, logits, bins = ctx.saved_tensors
        target = two_hot(x[:, 0], bins[0])
        probs = torch.softmax(logits.float(), dim=-1)
        dlogits = ((target - probs) * g).to(logits.dtype)
        return torch.zeros_like(x), dlogits, torch.zeros_like(bins)


def two_hot_log_prob(x, logits, bins):
    """x [N, 1] f32 targets, logits [N, K], bins [1, K] f32 -> log-prob
    [N, 1] f32. Differentiable wrt the logits through `_TwoHotLogProb`."""
    _check(x, logits, bins)
    if torch.is_grad_enabled() and logits.requires_grad:
        return _TwoHotLogProb.apply(x, logits, bins)
    return _forward(x, logits, bins)


two_hot_log_prob.launches = 0
