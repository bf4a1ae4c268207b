"""Why the f32 path of the tensor-core kernels splits each operand in three
(3xTF32, `csrc/mma_common.cuh`), and the launch plans of the two redesigned
kernels, on the CPU.

The TF32 rounding of `cvt.rna.tf32.f32` (round to nearest on the 10-bit
mantissa, ties away from zero) is emulated bit for bit; a product of two
TF32 values is exact in f32, so an f32 matmul of TF32-rounded operands
stands for the MMA's products with f32 sums. At kernel 2's path shapes
(K = 1,024, 3H = 1,536, B = 16, and 128 rows drawn as the B = 1,024 case
draws them) the LayerNorm-GRU output through 3xTF32 stays within the f32
kernels' tolerance (atol = rtol = 1e-4) of the float64 result with a wide
margin, while one TF32 product per pair misses it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops.kernels import gru, rssm

TOL = 1e-4  # the f32 kernels' atol and rtol against their plain versions
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may have on Hopper


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round half away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(a: torch.Tensor, w: torch.Tensor, passes: int) -> torch.Tensor:
    """a [B, K] @ w[N, K]^T in f32 from TF32 operands: one product a pair,
    or 3xTF32's three (a_lo b_hi + a_hi b_lo + a_hi b_hi)."""
    a_hi, a_lo = split(a)
    w_hi, w_lo = split(w)
    if passes == 1:
        return a_hi @ w_hi.t()
    return a_lo @ w_hi.t() + a_hi @ w_lo.t() + a_hi @ w_hi.t()


def ln_gru(parts, h, scale, offset, eps=1e-5):
    mean = parts.mean(-1, keepdim=True)
    c = parts - mean
    hat = c * torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    r, cand, u = (hat * scale + offset).chunk(3, dim=-1)
    update = torch.sigmoid(u - 1.0)
    return update * torch.tanh(torch.sigmoid(r) * cand) + (1.0 - update) * h


def gru_inputs(seed: int, rows: int, batch: int):
    """x, h, w, scale, offset at DreamerV3's width as chip_smoke.py draws them."""
    rng = np.random.default_rng(seed)
    k, n = 1024, 1536
    x = rng.standard_normal((batch, 512))[:rows]
    h = np.tanh(rng.standard_normal((batch, 512)))[:rows]
    w = rng.standard_normal((n, k)) * (2.0 / (k + n)) ** 0.5
    scale = 1.0 + 0.1 * rng.standard_normal(n)
    offset = 0.1 * rng.standard_normal(n)
    return [torch.from_numpy(v) for v in (x, h, w, scale, offset)]


def worst_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 within tolerance."""
    return float(((got.double() - want).abs() / (TOL + TOL * want.abs())).max())


@pytest.mark.parametrize("rows,batch", [(16, 16), (128, 1024)], ids=["scan_B16", "imagination_B1024_rows128"])
def test_3xtf32_keeps_the_gru_within_f32_tolerance(rows, batch):
    x, h, w, scale, offset = gru_inputs(rows + batch, rows, batch)
    xh = torch.cat([x, h], dim=-1)
    want = ln_gru(xh @ w.t(), h, scale, offset)
    f32 = [t.float() for t in (xh, w, h, scale, offset)]
    three = ln_gru(product(f32[0], f32[1], 3), *f32[2:])
    one = ln_gru(product(f32[0], f32[1], 1), *f32[2:])
    plain = ln_gru(f32[0] @ f32[1].t(), *f32[2:])
    r3, r1, rp = worst_ratio(three, want), worst_ratio(one, want), worst_ratio(plain, want)
    # 3xTF32 is as close to float64 as a plain f32 product, and far inside the tolerance
    assert r3 < 0.05, r3
    assert r3 < 4 * rp + 1e-3, (r3, rp)
    # a single TF32 product per pair is not
    assert r1 > 1.0, r1
    assert r1 > 50 * r3, (r1, r3)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the next TF32 value above 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, one + 2.0 ** -11 - 2.0 ** -23],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one]
    hi, lo = split(x)
    assert torch.equal(hi + lo, x[:4]) or float((hi + lo - x).abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
def test_gru_launch_plan_covers_every_width(itemsize):
    """Every hidden size up to MAX_HIDDEN at several batches and input
    widths: the splits cover K exactly in whole stages, none is empty, the
    tile rows are 16 or 64 and the stage ring fits shared memory."""
    depth = 128 // itemsize
    for hidden in range(1, gru.MAX_HIDDEN + 1):
        for batch, dx in ((1, hidden), (8, 37), (16, 1026), (1000, 512), (1024, 1)):
            k, n = dx + hidden, 3 * hidden
            plan = gru.launch_plan(batch, k, n, itemsize)
            kps, splits = plan["k_per_split"], plan["splits"]
            assert plan["bm"] == (16 if batch <= 16 else 64)
            assert kps % depth == 0 and kps > 0
            assert (splits - 1) * kps < k <= splits * kps, (hidden, batch, dx, plan)
            assert plan["smem"] <= SMEM_LIMIT
            assert 3 * hidden * 4 <= SMEM_LIMIT  # the row pass keeps a 3H f32 row


def _under_guard(dx, rec, d, hd, e, sd, itemsize):
    mats = d * dx + 3 * rec * (d + rec) + hd * rec + sd * hd + hd * (rec + e) + sd * hd
    vecs = 2 * d + 6 * rec + 4 * hd + 2 * sd
    return mats * itemsize + 4 * vecs <= 10 * 1024 * 1024


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
def test_fused_rssm_launch_plan(itemsize):
    """For widths under the reference's 10 MiB guard, the operand tile holds
    every stage's zero-padded operand, its rows are whole 16-byte chunks
    and 64 bytes past a multiple of 128 (conflict-free fragment reads), P
    holds the widest pre-activation; the CartPole path's widths fit shared
    memory in both dtypes."""
    widths = (1, 2, 3, 4, 5, 8, 16, 20, 24, 37, 40, 48, 64, 100, 128, 255, 256, 512, 768, 1024, 1026)
    checked = 0
    for dx in (1, 34, 37, 1026, 4096):
        for rec in widths:
            for hd in widths:
                d = e = rec
                sd = 2 * hd
                if not _under_guard(dx, rec, d, hd, e, sd, itemsize):
                    continue
                plan = rssm.launch_plan(dx, rec, d, hd, e, itemsize)
                chunk, lda, ldp = plan["chunk"], plan["lda"], plan["ldp"]
                assert chunk == 64 // itemsize

                def pad(n):
                    return -(-n // chunk) * chunk

                assert lda >= max(pad(dx), pad(d + rec), pad(rec + e), 2 * pad(hd))
                assert (lda * itemsize) % 128 == 64
                assert ldp >= max(d, 3 * rec, 2 * hd) and ldp % 4 == 0
                checked += 1
    assert checked > 1000
    cartpole = rssm.launch_plan(32 * 32 + 2, 512, 512, 512, 512, itemsize)
    assert cartpole["smem"] <= SMEM_LIMIT
