"""Why the f32 path of the tensor-core kernels splits each operand in three
(3xTF32, `csrc/mma_common.cuh`), and the launch plans of the tensor-core
kernels (the GRU, the fused RSSM step, the conv and the deconv), on the
CPU.

The TF32 rounding of `cvt.rna.tf32.f32` (round to nearest on the 10-bit
mantissa, ties away from zero) is emulated bit for bit; a product of two
TF32 values is exact in f32, so an f32 matmul of TF32-rounded operands
stands for the MMA's products with f32 sums. At kernel 2's path shapes
(K = 1,024, 3H = 1,536, B = 16, and 128 rows drawn as the B = 1,024 case
draws them) the LayerNorm-GRU output through 3xTF32 stays within the f32
kernels' tolerance (atol = rtol = 1e-4) of the float64 result with a wide
margin, while one TF32 product per pair misses it. The conv's and the
deconv's implicit GEMMs (the im2col rows against HWIO weight rows, K up to
2,048) are held the same way at an encoder and a decoder stage.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sheeprl_tpu_torch.ops.kernels import cnn, deconv, gru, rssm

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


def im2col(x: np.ndarray, kernel: str, phase: int = 0) -> tuple[np.ndarray, list]:
    """The implicit GEMM's A rows as the kernels gather them, K = tap * Cin +
    ci: the conv's 4 x 4 stride-2 window (SAME pads one pixel), or phase
    (dh, dw) of the deconv's 2 x 2 window over the input padded by one. ->
    (A [pixels, taps * Cin], the HWIO taps (ky, kx) of its K blocks)."""
    n, h, w, cin = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    if kernel == "conv":
        taps = [(ky, kx) for ky in range(4) for kx in range(4)]
        cols = [xp[:, ky:ky + h:2, kx:kx + w:2] for ky, kx in taps]
    else:
        dh, dw = divmod(phase, 2)
        taps = [(2 * a + dh, 2 * b + dw) for a in range(2) for b in range(2)]
        cols = [xp[:, dh + a:dh + a + h, dw + b:dw + b + w] for a in range(2) for b in range(2)]
    return np.concatenate(cols, axis=-1).reshape(-1, len(taps) * cin), taps


def ln_silu(pre, scale, offset, eps=1e-3):
    mean = pre.mean(-1, keepdim=True)
    c = pre - mean
    z = c * torch.rsqrt((c * c).mean(-1, keepdim=True) + eps) * scale + offset
    return z * torch.sigmoid(z)


# (kernel, N, input size, Cin, Cout): the last encoder stage and the first
# decoder stage of DreamerV3 at width 32 (K = 2,048 and 1,024)
STAGE_CASES = [("conv", 2, 8, 128, 256), ("deconv", 2, 4, 256, 128)]


@pytest.mark.parametrize("kernel,n,size,cin,cout", STAGE_CASES, ids=["encoder_128to256", "decoder_256to128"])
def test_3xtf32_keeps_the_conv_within_f32_tolerance(kernel, n, size, cin, cout):
    rng = np.random.default_rng(cin + cout)
    x = 1.0 / (1.0 + np.exp(-rng.standard_normal((n, size, size, cin))))
    x = x * rng.standard_normal((n, size, size, cin))  # silu-like activations
    w = rng.standard_normal((4, 4, cin, cout)) * (2.0 / (16 * (cin + cout))) ** 0.5
    scale = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(cout))
    offset = torch.from_numpy(0.1 * rng.standard_normal(cout))
    for phase in range(1 if kernel == "conv" else 4):
        a, taps = im2col(x, kernel, phase)
        wm = np.concatenate([w[ky, kx] for ky, kx in taps], axis=0)  # [K, Cout]: the weight rows
        a, wm = torch.from_numpy(a), torch.from_numpy(wm)
        want = ln_silu(a @ wm, scale, offset)
        a32, wt32, s32, o32 = a.float(), wm.t().contiguous().float(), scale.float(), offset.float()
        three = ln_silu(product(a32, wt32, 3), s32, o32)
        one = ln_silu(product(a32, wt32, 1), s32, o32)
        plain = ln_silu(a32 @ wt32.t(), s32, o32)
        r3, r1, rp = worst_ratio(three, want), worst_ratio(one, want), worst_ratio(plain, want)
        assert r3 < 0.05, (phase, r3)
        assert r3 < 4 * rp + 1e-3, (phase, r3, rp)
        assert r1 > 20 * r3, (phase, r1, r3)


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


RSSM_STATIC_SMEM = 16 * 2 * 8  # csrc/fused_rssm.cu's static `stats`


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
def test_fused_rssm_launch_plan(itemsize):
    """For widths under the reference's 10 MiB guard, with E and D swept
    independently of R: the operand tile holds every stage's zero-padded
    operand, its rows are whole 16-byte chunks and 64 bytes past a multiple
    of 128 (conflict-free fragment reads), P holds the widest
    pre-activation, and the shared memory (with the kernel's static 256
    bytes) fits the card at every width: the staged tiles where they fit,
    else the wide form's constant. The CartPole path's widths stay staged;
    the three widths that raised before the wide form take it."""
    widths = (1, 2, 3, 5, 8, 20, 37, 48, 64, 100, 128, 255, 256, 512, 768, 1024, 1026)
    fixed = {4: 4, 2: 6}[itemsize] * 16 * 512 + 8 * 2 * 16 * 8 * 4  # the rings and the partial tiles
    checked = wide = 0
    for dx in (1, 37, 1026, 4096):
        for rec in widths:
            for hd in widths:
                for d in (rec, 1, 40, 256, 512, 2048):
                    for e in (rec, 1, 20, 1024, 2048, 8192, 65536):
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
                        assert plan["smem"] + RSSM_STATIC_SMEM <= SMEM_LIMIT, (dx, rec, d, hd, e, plan)
                        staged = fixed + 16 * (lda * itemsize + ldp * 4) + 4 * max(2 * d, 6 * rec, 4 * hd)
                        assert plan["wide"] == (staged + RSSM_STATIC_SMEM > SMEM_LIMIT)
                        assert plan["smem"] == (fixed if plan["wide"] else staged)
                        checked += 1
                        wide += plan["wide"]
    assert checked > 5000 and wide > 100, (checked, wide)
    cartpole = rssm.launch_plan(32 * 32 + 2, 512, 512, 512, 512, itemsize)
    assert not cartpole["wide"] and cartpole["smem"] + RSSM_STATIC_SMEM <= SMEM_LIMIT
    # the widths that raised: pixels at multiplier 16 (bf16), R 512 with D =
    # Hd = 256 at E 1,024 (f32; bf16 fits staged) and E 8,192 (bf16)
    cases = {2: [(512, 512, 512, 2048), (512, 256, 256, 8192)], 4: [(512, 256, 256, 1024)]}[itemsize]
    for rec, d, hd, e in cases:
        assert _under_guard(1026, rec, d, hd, e, 1024, itemsize)
        plan = rssm.launch_plan(1026, rec, d, hd, e, itemsize)
        assert plan["wide"] and plan["smem"] == fixed


def _check_conv_plan(plan, pixels, k, cout, itemsize, phases):
    """What csrc/conv_common.cuh:check_plan requires, and the grid's limits."""
    elems = 16 // itemsize
    bm, bn, bk, splits, kps = plan["bm"], plan["bn"], plan["bk"], plan["splits"], plan["k_per_split"]
    assert (plan["wm"], bm, bn) == ((8, 256, 32) if cout <= 32 else (4, 128, 64))
    assert bk == (8 if bn == 64 else 4) * elems and plan["stages"] == 4
    assert kps > 0 and kps % bk == 0
    assert (splits - 1) * kps < k <= splits * kps, plan  # K covered, no split empty
    assert plan["smem"] == plan["stages"] * (bm * (bk + elems) + bk * (bn + 8)) * itemsize
    assert plan["smem"] <= SMEM_LIMIT
    gx, gy, gz = plan["grid"]
    assert (gx, gy, gz) == (-(-pixels // bm), -(-cout // bn), phases * splits)
    assert gx <= 2 ** 31 - 1 and gy <= 65535 and gz <= 65535
    assert plan["fused"] == (splits == 1 and cout <= bn)


CINS = (*range(1, 41), 48, 64, 96, 127, 128, 255, 256, 384, 512, 768, 1000, 1024)
COUTS = (*range(1, 41), 45, 63, 64, 65, 96, 128, 256, 511, 512, 513, 640, 768, 1024, 1536, 2047, 2048)


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["conv", "deconv"])
def test_conv_launch_plan_covers_every_width(kernel, itemsize):
    """Cin 1 ... 1,024, Cout 1 ... 2,048 at N = 1, 8 and 1,024 (64 x 64 and
    8 x 8 inputs for the conv, 16 x 16 and 4 x 4 for the deconv): the tile,
    the splits covering K in whole stages, the shared memory and the grid."""
    sizes = (64, 8) if kernel == "conv" else (16, 4)
    for n in (1, 8, 1024):
        for size in sizes:
            for cin in CINS:
                for cout in COUTS:
                    if kernel == "conv":
                        plan = cnn.launch_plan(n, size, size, cin, cout, itemsize)
                        _check_conv_plan(plan, n * (size // 2) ** 2, 16 * cin, cout, itemsize, 1)
                    else:
                        plan = deconv.launch_plan(n, size, size, cin, cout, itemsize)
                        _check_conv_plan(plan, n * size * size, 4 * cin, cout, itemsize, 4)
