"""The port's CUDA kernels on the card, against their plain versions, at the
serving path's shapes (DreamerV3 width, rungs 1 and 8) and at the training
path's (residual forwards and backwards, the deconv and two_hot, the fused
RSSM step at the CartPole path's widths and B = 1, 16 and 1,024), the
tensor-core GRU at B = 1 ... 1,024 and the tensor-core fused RSSM step also
at ragged widths (no width a whole 16-byte chunk or tile) and at the wide
widths whose staged tiles pass shared memory, the tensor-core conv and
deconv at Cout past 512, ragged Cin (3, 37) and Cout (45) and N = 1, 8 and
1,024, the fused
int8 SAC trunk (bit-exact, at Pendulum's and wider trunks, odd widths and
the device-memory scratch path) and symlog/symexp, and the gradient
reaching the parameters through CNN, DeCNN and LayerNormGRUCell on CUDA
tensors; one PPO update on the card against the CPU's and `ppo --dry_run`
on the card; each kernel captured in a CUDA graph and replayed equal to its
eager launch (kernel 5's cooperative launch, kernels 1/2's programmatic
dependent launch and kernel 6's cluster launch among them), a graphed
DreamerV3 run resumed on the CPU, and a graphed `serve --ckpt` with a
RELOAD and sessions that keep their rows; for continuous actions in
DreamerV3, the GRU's input gradients with frozen weights at B = 1,024
(imagination's backward) against the plain version's autograd, and the
continuous gradient step, served rung and device-Pendulum player chunk
each replayed as a graph against their eager or direct selves; kernels 3
and 3-res at the gray encoder's first stage (Cin = 1) in a graph, the
continuous gradient step under `--remat on` and `policy` replayed against
its eager self and `--remat off`'s, and the metric aggregator pulling
device values in one copy. Marked
`cuda`: they skip
without a CUDA device. The file imports neither jax nor the reference, so
it also runs on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: f32 atol/rtol 1e-4 (f32 sums in another order), bf16 2e-2
(one bf16 rounding of the output). Gradients are sums over every pixel of
a batch, which cancel: each is held to 1e-4 of its largest magnitude. The
int8 trunk is exact (integer products, the same f32 operations in the same
order); symlog/symexp f32 rtol/atol 1e-6, bf16 one bf16 ulp.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from sheeprl_tpu_torch.ops.kernels import cnn, deconv, gru, int8_trunk, rssm, symlog, two_hot

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STAGES = [(3, 32, 64), (32, 64, 32), (64, 128, 16), (128, 256, 8)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


# (B, Dx, H): DreamerV3's width at the serving rungs, the scan's 16 rows,
# imagination's 1,024 and a ragged 1,000; and a ragged width (Dx = 37 is
# not a whole 16-byte chunk in either dtype, 3H = 144 not a whole tile); the
# DreamerV3 learning receipt's player (B = 1) and imagination (B = 512) at width 256
GRU_SHAPES = [(1, 512, 512), (8, 512, 512), (16, 512, 512), (1000, 512, 512), (1024, 512, 512),
              (5, 37, 48), (1000, 37, 48), (1, 256, 256), (512, 256, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GRU_SHAPES, ids=lambda s: "B{}_Dx{}_H{}".format(*s))
def test_gru_kernel_matches_plain(cuda_device, dtype, shape):
    """Both forwards of csrc/ln_gru.cu (the serving one and the residual
    one) against their plain versions; hat and rstd are f32 and held to
    the f32 tolerance in either dtype (f32 sums of the same products)."""
    batch, dx, hidden = shape
    gen = torch.Generator().manual_seed(batch + dx)
    k, n = dx + hidden, 3 * hidden
    x = _rand(gen, batch, dx).to(cuda_device, dtype)
    h = torch.tanh(_rand(gen, batch, hidden)).to(cuda_device, dtype)
    w = _rand(gen, n, k, scale=k ** -0.5).to(cuda_device, dtype)
    scale = (1.0 + _rand(gen, n, scale=0.1)).to(cuda_device)
    offset = _rand(gen, n, scale=0.1).to(cuda_device)
    args = (x, h, w, scale, offset, 1e-5)
    before = gru.layernorm_gru_cell.launches, gru.layernorm_gru_cell_residuals.launches
    got = gru.layernorm_gru_cell(*args)
    got_res = gru.layernorm_gru_cell_residuals(*args)
    torch.cuda.synchronize()
    assert (gru.layernorm_gru_cell.launches, gru.layernorm_gru_cell_residuals.launches) == (
        before[0] + 1, before[1] + 1)
    want = gru.layernorm_gru_cell_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])
    for g, wv in zip(got_res, gru.layernorm_gru_cell_residuals_plain(*args)):
        tol = TOL[g.dtype]
        torch.testing.assert_close(g.float(), wv.float(), atol=tol, rtol=tol)


# (B, H = Dx, draws): the DreamerV3 learning receipt's GRU at width 256 (the
# player's B = 1, imagination's B = 512) and DreamerV3's default width 512
# (the player's B = 1, the scan's 16, imagination's 1,024)
GRU_ORACLE_CASES = [(1, 256, 64), (512, 256, 16), (1, 512, 64), (16, 512, 32), (1024, 512, 16)]
GRU_GRADS = ("dx", "dh", "dw", "dscale", "doffset")


def _gru_float64(x, h, w, scale, offset, eps):
    """The LayerNorm-GRU step in float64, the oracle: (h', hat, rstd)."""
    parts = torch.cat([x, h], dim=-1) @ w.t()
    centered = parts - parts.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((centered * centered).mean(dim=-1, keepdim=True) + eps)
    hat = centered * rstd
    r, c, u = (hat * scale + offset).chunk(3, dim=-1)
    update = torch.sigmoid(u - 1.0)
    return update * torch.tanh(torch.sigmoid(r) * c) + (1.0 - update) * h, hat, rstd


def _gru_grads(fn, args, g):
    leaves = [a.detach().clone().requires_grad_() for a in args[:5]]
    return torch.autograd.grad(fn(*leaves, args[5]), leaves, g)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GRU_ORACLE_CASES, ids=lambda c: "B{}_H{}".format(*c[:2]))
def test_gru_kernels_against_a_float64_oracle(cuda_device, case):
    """Kernels 1 and 2 and `_LayerNormGRU.backward` against float64, beside
    the plain version on the card against the same oracle. Each draw's f32
    inputs go through the kernel's forward (h'), the residual forward (h',
    hat, rstd), the kernel path's gradients (the residual forward, then the
    analytic backward) and autograd through the plain version; the oracle
    is the same step in float64 from the same f32 values, its gradients by
    float64 autograd. Over all draws, for each quantity, the largest error,
    the mean absolute error and the mean signed error (bias) are printed;
    also the analytic backward on the plain residual forward (what the CPU
    runs). Asserted: the kernel's largest and mean absolute errors are at
    most 2x the plain version's, and its bias is not measurably different
    from the plain version's: the paired difference of the draws' biases
    within 5 standard errors, or within 1 % of the plain version's mean
    absolute error, or within one f32 ulp of the quantity's mean magnitude
    (rounding level: two f32 implementations of rstd's reduction differ
    systematically by a fraction of an ulp, a CUDA-core FFMA projection's
    too)."""
    batch, hidden, draws = case
    dx, eps = hidden, 1e-5
    gen = torch.Generator().manual_seed(batch * 7 + hidden)
    errors: dict[str, dict[str, list]] = {}

    magnitude: dict[str, list] = {}

    def add(quantity, side, got, want):
        errors.setdefault(quantity, {}).setdefault(side, []).append((got.double() - want).flatten())
        magnitude.setdefault(quantity, []).append(want.abs().mean())

    def analytic_on_plain(x, h, w, scale, offset, eps_):
        real = gru.layernorm_gru_cell_residuals
        gru.layernorm_gru_cell_residuals = gru.layernorm_gru_cell_residuals_plain
        try:
            return gru._LayerNormGRU.apply(x, h, w, scale, offset, eps_)
        finally:
            gru.layernorm_gru_cell_residuals = real

    for _ in range(draws):
        x = _rand(gen, batch, dx).to(cuda_device)
        h = torch.tanh(_rand(gen, batch, hidden)).to(cuda_device)
        w = _rand(gen, 3 * hidden, dx + hidden, scale=(dx + hidden) ** -0.5).to(cuda_device)
        scale = (1.0 + _rand(gen, 3 * hidden, scale=0.1)).to(cuda_device)
        offset = _rand(gen, 3 * hidden, scale=0.1).to(cuda_device)
        g = _rand(gen, batch, hidden).to(cuda_device)
        args = (x, h, w, scale, offset, eps)
        args64 = tuple(a.double() for a in args[:5]) + (eps,)
        with torch.no_grad():
            want = _gru_float64(*args64)
            add("h' (kernel 1)", "kernel", gru.layernorm_gru_cell(*args), want[0])
            add("h' (kernel 1)", "plain", gru.layernorm_gru_cell_plain(*args), want[0])
            for name, got, plain, oracle in zip(("h' (kernel 2)", "hat", "rstd"),
                                                gru.layernorm_gru_cell_residuals(*args),
                                                gru.layernorm_gru_cell_residuals_plain(*args), want):
                add(name, "kernel", got, oracle)
                add(name, "plain", plain, oracle)
        want_grads = _gru_grads(lambda *a: _gru_float64(*a)[0], args64, g.double())
        sides = {"kernel": gru.layernorm_gru_cell, "plain": gru.layernorm_gru_cell_plain,
                 "analytic on plain": analytic_on_plain}
        for side, fn in sides.items():
            for name, got, oracle in zip(GRU_GRADS, _gru_grads(fn, args, g), want_grads):
                add(name, side, got, oracle)

    failures = []
    for quantity, sides in errors.items():
        stats = {}
        for side, errs in sides.items():
            flat = torch.cat(errs)
            stats[side] = dict(max=float(flat.abs().max()), mean_abs=float(flat.abs().mean()),
                               bias=float(flat.mean()), biases=torch.stack([e.mean() for e in errs]))
        k, p = stats["kernel"], stats["plain"]
        diff = k["biases"] - p["biases"]
        stderr = float(diff.std() / len(diff) ** 0.5) if len(diff) > 1 else 0.0
        gap = abs(float(diff.mean()))
        ulp = torch.finfo(torch.float32).eps * float(torch.stack(magnitude[quantity]).mean())
        print(f"[gru-oracle] B={batch} H={hidden} {draws} draws {quantity}: " + " | ".join(
            f"{side} max {s['max']:.3e} mean_abs {s['mean_abs']:.3e} bias {s['bias']:+.3e}"
            for side, s in stats.items()) + f" | bias gap {gap:.3e} ({gap / stderr if stderr else 0.0:.2f} s.e., "
            f"{gap / ulp:.2f} ulp)")
        if k["max"] > 2 * p["max"] or k["mean_abs"] > 2 * p["mean_abs"]:
            failures.append(f"{quantity}: the kernel's error is more than 2x the plain version's")
        if gap > max(5 * stderr, 0.01 * p["mean_abs"], ulp):
            failures.append(f"{quantity}: the kernel's bias {k['bias']:+.3e} differs from the plain version's "
                            f"{p['bias']:+.3e} by {gap:.3e} ({gap / stderr:.2f} standard errors)")
    assert not failures, failures


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", STAGES, ids=lambda s: f"{s[0]}to{s[1]}at{s[2]}")
@pytest.mark.parametrize("n", [1, 8])
def test_conv_kernel_matches_plain(cuda_device, dtype, stage, n):
    cin, cout, size = stage
    gen = torch.Generator().manual_seed(cin + n)
    x = torch.rand(n, size, size, cin, generator=gen).to(cuda_device, dtype)
    w = _rand(gen, 4, 4, cin, cout, scale=(2.0 / (16 * (cin + cout))) ** 0.5).to(cuda_device, dtype)
    scale = (1.0 + _rand(gen, cout, scale=0.1)).to(cuda_device)
    offset = _rand(gen, cout, scale=0.1).to(cuda_device)
    before = cnn.conv_ln_silu.launches
    got = cnn.conv_ln_silu(x, w, scale, offset, 1e-3)
    torch.cuda.synchronize()
    assert cnn.conv_ln_silu.launches == before + 1
    want = cnn.conv_ln_silu_plain(x, w, scale, offset, 1e-3)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros(2, 8, device=cuda_device)
    h = torch.zeros(2, 8, device=cuda_device)
    w = torch.zeros(16, 24, device=cuda_device).t()  # [24, 16] view, not contiguous
    ones, zeros = torch.ones(24, device=cuda_device), torch.zeros(24, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        gru.layernorm_gru_cell(x, h, w, ones, zeros)
    cx = torch.zeros(1, 8, 8, 3, device=cuda_device)
    cw = torch.zeros(4, 4, 3, 8, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        cnn.conv_ln_silu(cx, cw.cpu(), torch.ones(8), torch.zeros(8))


def _grad_close(got, want, tol=1e-4):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * max(scale, 1e-30), (float((got - want).abs().max()), scale)


@pytest.mark.cuda
def test_residual_kernels_match_plain_and_count(cuda_device):
    gen = torch.Generator().manual_seed(3)
    dev = cuda_device
    x, h = _rand(gen, 16, 512).to(dev), torch.tanh(_rand(gen, 16, 512)).to(dev)
    w = _rand(gen, 1536, 1024, scale=0.03).to(dev)
    sc, of = (1.0 + _rand(gen, 1536, scale=0.1)).to(dev), _rand(gen, 1536, scale=0.1).to(dev)
    before = gru.layernorm_gru_cell_residuals.launches
    got = gru.layernorm_gru_cell_residuals(x, h, w, sc, of, 1e-5)
    want = gru.layernorm_gru_cell_residuals_plain(x, h, w, sc, of, 1e-5)
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, atol=1e-4, rtol=1e-4)
    assert gru.layernorm_gru_cell_residuals.launches == before + 1
    cx = torch.rand(64, 32, 32, 32, generator=gen).to(dev)
    cw = _rand(gen, 4, 4, 32, 64, scale=0.05).to(dev)
    cs, co = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    for g, wv in zip(cnn.conv_ln_silu_residuals(cx, cw, cs, co, 1e-3), cnn.conv_ln_silu_residuals_plain(cx, cw, cs, co, 1e-3)):
        torch.testing.assert_close(g, wv, atol=1e-4, rtol=1e-4)
    dx = _rand(gen, 64, 8, 8, 128).to(dev)
    dk = _rand(gen, 4, 4, 128, 64, scale=0.03).to(dev)
    before = deconv.deconv_ln_silu.launches
    for g, wv in zip(deconv.deconv_ln_silu_residuals(dx, dk, cs, co, 1e-3),
                     deconv.deconv_ln_silu_residuals_plain(dx, dk, cs, co, 1e-3)):
        torch.testing.assert_close(g, wv, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(deconv.deconv_ln_silu(dx, dk, cs, co, 1e-3),
                               deconv.deconv_ln_silu_plain(dx, dk, cs, co, 1e-3), atol=1e-4, rtol=1e-4)
    assert deconv.deconv_ln_silu.launches == before + 2
    bins = torch.linspace(-20.0, 20.0, 255, device=dev)[None]
    tx = (8.0 * _rand(gen, 1024, 1)).to(dev)
    logits = _rand(gen, 1024, 255, scale=2.0).to(dev)
    torch.testing.assert_close(two_hot.two_hot_log_prob(tx, logits, bins),
                               two_hot.two_hot_log_prob_plain(tx, logits, bins), atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_gradient_reaches_the_parameters_on_cuda(cuda_device):
    """backward() through CNN, DeCNN and LayerNormGRUCell on CUDA tensors
    fills every parameter's .grad, equal to the CPU's (the plain versions
    under the same autograd.Functions)."""
    from sheeprl_tpu_torch.nn.blocks import CNN, DeCNN
    from sheeprl_tpu_torch.nn.recurrent import LayerNormGRUCell

    gen = torch.Generator().manual_seed(0)
    kw = dict(act="silu", layer_norm=True, use_bias=False, norm_eps=1e-3, generator=gen)
    modules = {
        "cnn": CNN(3, [8, 16], kernel_sizes=[4, 4], strides=[2, 2], **kw),
        "decnn": DeCNN(16, [8, 3], kernel_sizes=[4, 4], strides=[2, 2], **kw),
        "gru": LayerNormGRUCell(12, 16, generator=gen),
    }
    inputs = {
        "cnn": (torch.rand(4, 16, 16, 3, generator=gen),),
        "decnn": (_rand(gen, 4, 4, 4, 16),),
        "gru": (_rand(gen, 4, 12), torch.tanh(_rand(gen, 4, 16))),
    }
    counters = (cnn.conv_ln_silu_residuals, deconv.deconv_ln_silu, gru.layernorm_gru_cell_residuals)
    before = [c.launches for c in counters]
    for name, module in modules.items():
        grads = {}
        for device in ("cpu", cuda_device):
            m = module.to(device)
            m.zero_grad(set_to_none=True)
            out = m(*[t.detach().to(device).requires_grad_(t.dim() == 2 or name == "decnn") for t in inputs[name]])
            out.float().pow(2).mean().backward()
            grads[str(device)] = {n: p.grad.detach().cpu() for n, p in m.named_parameters() if p.requires_grad}
        cpu, gpu = grads["cpu"], grads[str(cuda_device)]
        assert set(gpu) == {n for n, _ in module.named_parameters()}, name
        for n in cpu:
            assert float(gpu[n].abs().max()) > 0, f"{name}.{n}"
            _grad_close(gpu[n], cpu[n])
    assert all(c.launches > b for c, b in zip(counters, before))


def _rssm_inputs(gen, device, dtype, batch, dx=1026, rec=512, d=512, hd=512, e=512, sd=1024):
    """x, h, emb and the 16 weights of one fused RSSM step at the CartPole
    training path's widths ([out, in] matrices in `dtype`, the LN affines
    and head biases f32)."""
    def mat(o, i):
        return _rand(gen, o, i, scale=(1.0 / i) ** 0.5).to(device, dtype)

    def vec(n, base=0.0):
        return (base + _rand(gen, n, scale=0.1)).to(device)

    x = torch.eye(32)[torch.randint(0, 32, (batch, 32), generator=gen)].reshape(batch, -1)
    x = torch.cat([x, torch.eye(2)[torch.randint(0, 2, (batch,), generator=gen)]], dim=-1)[:, :dx]
    return [
        x.to(device, dtype), torch.tanh(_rand(gen, batch, rec)).to(device, dtype),
        _rand(gen, batch, e).to(device, dtype),
        mat(d, dx), vec(d, 1.0), vec(d), mat(3 * rec, d + rec), vec(3 * rec, 1.0), vec(3 * rec),
        mat(hd, rec), vec(hd, 1.0), vec(hd), mat(sd, hd), vec(sd),
        mat(hd, rec + e), vec(hd, 1.0), vec(hd), mat(sd, hd), vec(sd),
    ]


# the CartPole path's widths (wm's rows are 1,026 elements: 2,052 bytes
# apart in bf16, only 4-byte aligned) and a ragged set (no width a whole
# chunk or tile; wm's bf16 rows 74 bytes apart, only 2-byte aligned), in
# both dtypes; and the wide steps, whose staged tiles would pass shared
# memory, each in the dtypes the 10 MiB guard admits: pixels at
# --cnn_channels_multiplier 16 (E 2,048) in bf16, R 512 / E 1,024 / D = Hd
# = 256 in both, and the widest bf16 case, E 8,192
RSSM_DIMS = {
    "cartpole": {}, "ragged": dict(dx=37, rec=48, d=40, hd=24, e=20, sd=72),
    "pixels_m16": dict(e=2048), "e1024": dict(d=256, hd=256, e=1024), "e8192": dict(d=256, hd=256, e=8192),
    # the DreamerV3 learning receipt's widths (tests/test_algos/test_learning.py:215-245)
    "receipt": dict(dx=258, rec=256, d=256, hd=256, e=256, sd=256),
}
RSSM_CASES = [(dims, dtype) for dims in ("cartpole", "ragged", "e1024", "receipt")
              for dtype in (torch.float32, torch.bfloat16)]
RSSM_CASES += [("pixels_m16", torch.bfloat16), ("e8192", torch.bfloat16)]
# the cases whose staged tiles pass shared memory (E 1,024 fits in bf16)
WIDE_RSSM_CASES = {("pixels_m16", torch.bfloat16), ("e8192", torch.bfloat16), ("e1024", torch.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 16, 1024])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dims,dtype", RSSM_CASES, ids=lambda v: str(v).split(".")[-1])
def test_fused_rssm_kernel_matches_plain(cuda_device, dtype, batch, act, dims):
    gen = torch.Generator().manual_seed(batch)
    inputs = _rssm_inputs(gen, cuda_device, dtype, batch, **RSSM_DIMS[dims])
    if dims in ("pixels_m16", "e1024", "e8192"):  # widths the reference's guard runs fused
        assert rssm.fused_rssm_supported(act, *inputs[3:])
    width = dict(dx=1026, rec=512, d=512, hd=512, e=512) | RSSM_DIMS[dims]
    wide = rssm.launch_plan(width["dx"], width["rec"], width["d"], width["hd"], width["e"],
                            inputs[0].element_size())["wide"]
    assert wide == ((dims, dtype) in WIDE_RSSM_CASES)
    before = rssm.fused_rssm_step.launches
    with torch.no_grad():
        got = rssm.fused_rssm_step(*inputs, act, (1e-3, 1e-5, 1e-3))
    torch.cuda.synchronize()
    assert rssm.fused_rssm_step.launches == before + 1
    want = rssm.fused_rssm_step_plain(*inputs, act, (1e-3, 1e-5, 1e-3))
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    for g, w in zip(got, want):  # h' in the compute dtype, the raw logits f32
        tol = TOL[dtype]
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_rssm_backward_matches_plain(cuda_device, dtype):
    """The 19 gradients through `_FusedRSSM` (kernel forward, plain
    recompute backward) against autograd through the plain version."""
    gen = torch.Generator().manual_seed(5)
    inputs = _rssm_inputs(gen, cuda_device, dtype, 16)
    cots = None
    grads = []
    for fn in (rssm.fused_rssm_step, rssm.fused_rssm_step_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        outs = fn(*leaves, "silu", (1e-3, 1e-5, 1e-3))
        if cots is None:
            cots = [torch.randn(o.shape, generator=gen).to(cuda_device, o.dtype) for o in outs]
        grads.append(torch.autograd.grad(outs, leaves, cots))
    for g, w in zip(*grads):
        assert torch.isfinite(g.float()).all()
        _grad_close(g.float(), w.float(), tol=TOL[dtype])


@pytest.mark.cuda
def test_fused_rssm_raises_instead_of_falling_back(cuda_device):
    gen = torch.Generator().manual_seed(0)
    inputs = _rssm_inputs(gen, cuda_device, torch.float32, 4, dx=34, rec=16, d=16, hd=16, e=16, sd=32)
    mixed = list(inputs)
    mixed[4] = mixed[4].cpu()  # one LayerNorm scale left on the CPU
    with pytest.raises(ValueError, match="one device"):
        rssm.fused_rssm_step(*mixed)
    strided = list(inputs)
    strided[3] = strided[3].t().contiguous().t()  # [out, in] values, column-major
    with pytest.raises(ValueError, match="contiguous"):
        rssm.fused_rssm_step(*strided)
    with pytest.raises(ValueError, match="activation"):
        rssm.fused_rssm_step(*inputs, "sigmoid")


def _stage(gen, device, dtype, n, size, cin, cout):
    """x [n, size, size, cin], an HWIO kernel [4, 4, cin, cout], scale and
    offset, drawn as the stages of a DreamerV3 CNN are."""
    x = torch.nn.functional.silu(_rand(gen, n, size, size, cin)).to(device, dtype)
    w = _rand(gen, 4, 4, cin, cout, scale=(2.0 / (16 * (cin + cout))) ** 0.5).to(device, dtype)
    return x, w, (1.0 + _rand(gen, cout, scale=0.1)).to(device), _rand(gen, cout, scale=0.1).to(device)


def _both_forwards_match(kernel, args, dtype):
    """The plain forward and the residual forward of `kernel` ("conv" or
    "deconv") on the card against their plain versions, one counted launch
    each; the f32 residual at the f32 tolerance in either dtype."""
    if kernel == "conv":
        fwd, res, fwd_plain, res_plain = (cnn.conv_ln_silu, cnn.conv_ln_silu_residuals, cnn.conv_ln_silu_plain,
                                          cnn.conv_ln_silu_residuals_plain)
        counters = (cnn.conv_ln_silu, cnn.conv_ln_silu_residuals)
    else:
        fwd, res, fwd_plain, res_plain = (deconv.deconv_ln_silu, deconv.deconv_ln_silu_residuals,
                                          deconv.deconv_ln_silu_plain, deconv.deconv_ln_silu_residuals_plain)
        counters = (deconv.deconv_ln_silu, deconv.deconv_ln_silu)
    before = sum(c.launches for c in set(counters))
    with torch.no_grad():
        got = fwd(*args, 1e-3)
        got_res = res(*args, 1e-3)
    torch.cuda.synchronize()
    assert sum(c.launches for c in set(counters)) == before + 2
    torch.testing.assert_close(got.float(), fwd_plain(*args, 1e-3).float(), atol=TOL[dtype], rtol=TOL[dtype])
    for g, w in zip(got_res, res_plain(*args, 1e-3)):
        tol = TOL[g.dtype]
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cout", [513, 768, 1024])
@pytest.mark.parametrize("kernel", ["conv", "deconv"])
def test_wide_stage_matches_plain_on_cuda(cuda_device, kernel, cout, dtype):
    """Stages wider than the 512 channels a warp's registers hold in the
    pixel pass (the reference's guard admits any Cout): both forwards
    launch and match their plain versions."""
    gen = torch.Generator().manual_seed(cout)
    args = _stage(gen, cuda_device, dtype, 2, 8 if kernel == "conv" else 4, 16, cout)
    _both_forwards_match(kernel, args, dtype)


@pytest.mark.cuda
def test_wide_cnn_stage_runs_through_the_module_on_cuda(cuda_device):
    """A CNN stage of Cout 513 through the module, forward and backward, on
    the kernel: the gradient equals the CPU's plain one."""
    from sheeprl_tpu_torch.nn.blocks import CNN

    gen = torch.Generator().manual_seed(1)
    wide = CNN(8, [513], kernel_sizes=[4], strides=[2], act="silu", layer_norm=True, use_bias=False,
               generator=gen)
    x = torch.rand(2, 8, 8, 8, generator=gen)
    grads = {}
    for device in ("cpu", cuda_device):
        m = wide.to(device)
        m.zero_grad(set_to_none=True)
        m(x.to(device)).pow(2).mean().backward()
        grads[str(device)] = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
    for n, g in grads["cpu"].items():
        _grad_close(grads[str(cuda_device)][n], g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 8, 1024])
@pytest.mark.parametrize("cin,cout", [(3, 32), (37, 45)], ids=["cin3_cout32", "cin37_cout45"])
@pytest.mark.parametrize("kernel", ["conv", "deconv"])
def test_ragged_stage_matches_plain_on_cuda(cuda_device, kernel, cin, cout, n, dtype):
    """Channels that are not whole 16-byte chunks (the first encoder stage's
    Cin 3; Cin 37 and an odd Cout 45, gathered element by element) at one
    image, the serving rung and the training batch."""
    gen = torch.Generator().manual_seed(n + cin)
    args = _stage(gen, cuda_device, dtype, n, 8, cin, cout)
    _both_forwards_match(kernel, args, dtype)


def _int8_trunk(gen, dims, batch):
    """x [batch, dims[0]] and the 12 trunk tensors (in_scale, w_q [out, in],
    w_scale, bias per layer), quantized as `QuantLinear.from_linear` does
    with scales calibrated on another draw of inputs, on the CPU."""
    from sheeprl_tpu_torch.ops.quant import absmax_scale, quantize

    a = 2.0 * torch.randn(256, dims[0], generator=gen)
    tensors = []
    for i, (n_in, n_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn(n_out, n_in, generator=gen) / n_in ** 0.5
        b = 0.1 * torch.randn(n_out, generator=gen)
        s_in = a.abs().amax(0).clamp_min(1e-8 * 127) / 127
        w_eff = w * s_in[None, :]
        w_scale = absmax_scale(w_eff, dim=1)
        tensors += [s_in, quantize(w_eff, w_scale[:, None]), w_scale, b]
        a = a @ w.T + b
        if i < 2:
            a = torch.relu(a)
    return 2.0 * torch.randn(batch, dims[0], generator=gen), tensors


@pytest.mark.cuda
@pytest.mark.parametrize("dims,batch", [
    *(((3, 256, 256, 1), b) for b in (1, 2, 4, 8, 64, 1024)),  # Pendulum, the serving rungs and more
    ((17, 1024, 1024, 6), 8), ((17, 1024, 1024, 6), 1024),     # HalfCheetah's widths
    ((5, 300, 18, 2), 33),                                      # odd widths, ragged blocks
    ((3, 12288, 64, 1), 20),                                    # hidden images in device memory
    ((3, 20000, 64, 1), 20),                                    # wider, in device memory too
    ((3, 3224, 3224, 1), 8), ((3, 3224, 3224, 1), 40),          # the widest trunk the 10 MiB guard admits
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_int8_trunk_kernel_is_bit_exact(cuda_device, dims, batch):
    gen = torch.Generator().manual_seed(batch + sum(dims))
    x, tensors = _int8_trunk(gen, dims, batch)
    assert int8_trunk.fused_int8_trunk_supported(*tensors)
    x, tensors = x.to(cuda_device), [t.to(cuda_device) for t in tensors]
    before = int8_trunk.fused_int8_trunk.launches
    got = int8_trunk.fused_int8_trunk(x, *tensors)
    torch.cuda.synchronize()
    assert int8_trunk.fused_int8_trunk.launches == before + 1
    want = int8_trunk.int8_trunk_reference(x, *tensors)
    assert got.shape == (batch, dims[-1]) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), float((got - want).abs().max())
    # the CPU's plain version agrees too: the same integers, the same f32 steps
    assert torch.equal(got.cpu(), int8_trunk.int8_trunk_reference(x.cpu(), *[t.cpu() for t in tensors]))


# (N, K): the misaligned N = 1,023, K = 257 (a 1,028-byte f32 row), the
# critic loss's N = 15,360 at the default 255 bins, K past the 1,024 the
# first kernel took (1,025, 2,048, 4,096: fault 3 of ROADMAP Queue C) at odd
# N, one bin, and rows too long for a stage (chunked, the bins staged with
# each chunk); `offset` starts the logits 4 bytes past an aligned address
TWO_HOT_SHAPES = [(1023, 257), (15360, 255), (33, 1025), (1001, 2048), (17, 4096), (9, 1), (7, 20001), (3, 40000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("shape", TWO_HOT_SHAPES, ids=lambda s: "N{}_K{}".format(*s))
def test_two_hot_kernel_matches_plain_at_any_bins(cuda_device, shape, offset, dtype):
    n, k = shape
    gen = torch.Generator().manual_seed(n + k)
    bins = torch.linspace(-20.0, 20.0, k)[None].to(cuda_device)
    x = 6.0 * torch.randn(n, 1, generator=gen)
    x[::7] = 25.0 * torch.sign(x[::7])  # beyond the edge bins
    x[3::11] = bins[0, k // 2].cpu()    # on a bin
    x[5::13] = float("nan")             # lands where the reference puts it
    x = x.to(cuda_device)
    flat = torch.empty(n * k + offset, dtype=dtype, device=cuda_device)
    logits = flat[offset:].view(n, k)
    logits.copy_(_rand(gen, n, k, scale=2.0))
    before = two_hot.two_hot_log_prob.launches
    got = two_hot.two_hot_log_prob(x, logits, bins)
    torch.cuda.synchronize()
    assert two_hot.two_hot_log_prob.launches == before + 1
    want = two_hot.two_hot_log_prob_plain(x, logits, bins)
    assert got.shape == (n, 1) and got.dtype == torch.float32
    tol = TOL[dtype]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol, equal_nan=True)


@pytest.mark.cuda
def test_two_hot_distribution_log_prob_at_2048_bins_on_cuda(cuda_device):
    """`--bins 2048` on the card: the reward head's log_prob goes through
    the kernel and agrees with the same distribution on the CPU."""
    from sheeprl_tpu_torch.ops.distributions import TwoHotEncodingDistribution

    gen = torch.Generator().manual_seed(2048)
    logits = _rand(gen, 16, 64, 2048, scale=2.0)
    target = 50.0 * _rand(gen, 16, 64, 1)
    want = TwoHotEncodingDistribution(logits, dims=1).log_prob(target)
    before = two_hot.two_hot_log_prob.launches
    got = TwoHotEncodingDistribution(logits.to(cuda_device), dims=1).log_prob(target.to(cuda_device))
    torch.cuda.synchronize()
    assert two_hot.two_hot_log_prob.launches == before + 1
    assert got.shape == want.shape == (16, 64)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_int8_trunk_raises_instead_of_falling_back(cuda_device):
    gen = torch.Generator().manual_seed(0)
    x, tensors = _int8_trunk(gen, (3, 16, 16, 1), 4)
    x, tensors = x.to(cuda_device), [t.to(cuda_device) for t in tensors]
    mixed = list(tensors)
    mixed[3] = mixed[3].cpu()
    with pytest.raises(ValueError, match="one device"):
        int8_trunk.fused_int8_trunk(x, *mixed)
    with pytest.raises(ValueError, match="contiguous"):
        int8_trunk.fused_int8_trunk(x.t().contiguous().t(), *tensors)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 20])
def test_int8_trunk_wraps_like_int32_on_cuda(cuda_device, batch):
    """Layer 0 at K = 140,000 with every x_q and w_q at 127: the int32 sum
    127^2 * 140,000 wraps, in the reference's accumulator and in the plain
    version. The kernel cuts K into product chains of at most 131,072 and
    adds their partials with wrapping adds: it must land on the same
    wrapped value, bit for bit, through the layers after it."""
    k, hidden = 140_000, 64
    gen = torch.Generator().manual_seed(k)
    _, rest = _int8_trunk(gen, (hidden, hidden, hidden, 1), batch)
    layer0 = [torch.ones(k), torch.full((hidden, k), 127, dtype=torch.int8),
              torch.full((hidden,), -1e-9), torch.zeros(hidden)]
    tensors = [t.to(cuda_device) for t in layer0 + rest[4:]]
    assert int8_trunk.fused_int8_trunk_supported(*tensors)
    plan = int8_trunk.launch_plan(batch, k, hidden, hidden, 1)
    assert plan["layers"][0]["splits"] > 1 and plan["layers"][0]["k_blocks_per_split"] * 64 <= 131_072
    x = torch.full((batch, k), 127.0, device=cuda_device)
    before = int8_trunk.fused_int8_trunk.launches
    got = int8_trunk.fused_int8_trunk(x, *tensors)
    torch.cuda.synchronize()
    assert int8_trunk.fused_int8_trunk.launches == before + 1
    want = int8_trunk.int8_trunk_reference(x, *tensors)
    assert torch.equal(got, want), float((got - want).abs().max())
    # what reaches layer 1 is the wrapped sum: times -1e-9 it is positive and
    # passes the ReLU, where the unwrapped 2.26e9 would give -2.26 and 0
    from sheeprl_tpu_torch.ops.quant import int8_linear

    assert bool((int8_linear(x, *tensors[:4]) > 2.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["build", "launch"])
def test_serve_raises_when_the_int8_kernel_fails(cuda_device, tmp_path, monkeypatch, fault):
    """On the card, a kernel 6 that fails to build or launch stops
    `serve --quant int8` before it listens: no rung steps aside to f32."""
    from sheeprl_tpu_torch.cli import run

    real_bind = int8_trunk.bind

    def failing_bind(source, symbol, *args, **kwargs):
        if fault == "build":
            raise RuntimeError(f"nvcc failed for {source}.cu")
        if symbol == "fused_int8_trunk_forward":
            return lambda *call_args: 1  # cudaErrorInvalidValue
        return real_bind(source, symbol, *args, **kwargs)

    monkeypatch.setattr(int8_trunk, "bind", failing_bind)
    with pytest.raises(RuntimeError, match="nvcc failed" if fault == "build" else "launch failed"):
        run(["serve", "--algo", "sac", "--quant", "int8", "--model_argv", "--actor_hidden_size 32",
             "--root_dir", str(tmp_path), "--run_name", "r", "--dry_run"])
    assert not (tmp_path / "r" / "serve_address").exists()


def _ordered_bf16(t):
    """bf16 bit patterns mapped to integers that are ordered like the values
    (+0 and -0 both 0), so one bf16 ulp is a difference of 1."""
    bits = t.view(torch.int16).int()
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _close_bf16_or_f32(got, want):
    if got.dtype == torch.bfloat16:
        same_nan = torch.isnan(got) == torch.isnan(want)
        assert same_nan.all()
        ok = ~torch.isnan(want)
        assert int((_ordered_bf16(got) - _ordered_bf16(want))[ok].abs().max()) <= 1
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1024, 255), (4096,)], ids=["1024x255", "4096"])
@pytest.mark.parametrize("name", ["symlog", "symexp"])
def test_symlog_kernels_match_plain(cuda_device, name, shape, dtype):
    gen = torch.Generator().manual_seed(len(shape))
    scale = 20.0 if name == "symlog" else 4.0
    x = (scale * torch.randn(*shape, generator=gen))
    x.view(-1)[:4] = torch.tensor([0.0, -0.0, float("nan"), 1e-6])
    x = x.to(cuda_device, dtype)
    fn, plain = getattr(symlog, name), getattr(symlog, f"{name}_plain")
    before = fn.launches
    got = fn(x)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and got.dtype == dtype
    _close_bf16_or_f32(got, plain(x))
    # backward: the analytic formula against autograd through the plain version
    xg = x.clone()
    xg.view(-1)[:4] = 1.0  # autograd through sign(x) * f(|x|) gives 0 at x = 0 and NaN at NaN
    g = torch.randn(*shape, generator=gen).to(cuda_device, dtype)
    leaf = xg.clone().requires_grad_(True)
    (got_grad,) = torch.autograd.grad(fn(leaf), leaf, g)
    leaf = xg.clone().requires_grad_(True)
    (want_grad,) = torch.autograd.grad(plain(leaf), leaf, g)
    _close_bf16_or_f32(got_grad, want_grad)


SYMLOG_LENGTHS = [1, 2, 3, 7, 8, 9, 15, 16, 17, 31, 255, 1023, 4097, 100_003]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["symlog", "symexp"])
def test_symlog_kernels_at_odd_lengths_and_offset_views(cuda_device, name, dtype):
    """Kernel 8's head, body and tail at lengths that leave every remainder,
    on `x[k:]` views of one buffer at every element offset within 16 bytes
    (so x and the fresh output differ in alignment mod 16): each against its
    plain version, each launch counted once."""
    fn, plain = getattr(symlog, name), getattr(symlog, f"{name}_plain")
    gen = torch.Generator().manual_seed(11)
    scale = 20.0 if name == "symlog" else 4.0
    buf = (scale * torch.randn(max(SYMLOG_LENGTHS) + 16, generator=gen)).to(cuda_device, dtype)
    item = buf.element_size()
    for n in SYMLOG_LENGTHS:
        for k in range(16 // item):
            x = buf[k:k + n]
            assert x.is_contiguous() and x.data_ptr() % 16 == (k * item) % 16
            before = fn.launches
            got = fn(x)
            torch.cuda.synchronize()
            assert fn.launches == before + 1 and got.shape == x.shape
            _close_bf16_or_f32(got, plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["symlog", "symexp"])
def test_symlog_kernels_at_the_timed_size_and_special_values(cuda_device, name, dtype):
    """[65,536, 1,024], the size phase 3 of chip_smoke.py times, with 0, -0,
    NaN, +-inf and 1e-6 in it; the special values also alone, against their
    exact results (sign(+-0) = 0 and sign(NaN) = 0 as torch.sign has them)."""
    fn, plain = getattr(symlog, name), getattr(symlog, f"{name}_plain")
    gen = torch.Generator().manual_seed(12)
    x = (20.0 if name == "symlog" else 4.0) * torch.randn(65536, 1024, generator=gen)
    specials = torch.tensor([0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1e-6])
    x.view(-1)[1000:1000 + len(specials)] = specials
    x = x.to(cuda_device, dtype)
    _close_bf16_or_f32(fn(x), plain(x))
    s = specials.to(cuda_device, dtype)
    got = fn(s)
    _close_bf16_or_f32(got, plain(s))  # 1e-6 too: exp(x) - 1 cancels alike in both
    inf = float("inf")
    want = torch.tensor([0.0, 0.0, float("nan"), inf, -inf])
    head = got[:5].float().cpu()
    assert torch.equal(torch.isnan(head), torch.isnan(want))
    assert torch.equal(head[~torch.isnan(want)], want[~torch.isnan(want)])
    assert float(got[5]) > 0


@pytest.mark.cuda
def test_checkpoint_round_trip_onto_the_card(cuda_device, tmp_path):
    """A port DreamerV3 checkpoint written on the CPU loads onto the card
    (`map_location`) bit for bit, into a state on the card that trains on
    from it, and `main --checkpoint_path` resumes on the card."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, to_host

    root = str(tmp_path)
    tiny = ["--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "1", "--cnn_channels_multiplier", "2",
            "--dense_units", "16", "--hidden_size", "16", "--recurrent_state_size", "16", "--stochastic_size", "4",
            "--discrete_size", "4", "--per_rank_batch_size", "2", "--per_rank_sequence_length", "4", "--horizon",
            "3", "--learning_starts", "16", "--total_steps", "24", "--train_every", "2", "--buffer_size", "64",
            "--bins", "15", "--checkpoint_every", "4", "--checkpoint_buffer", "--root_dir", root, "--run_name", "r"]
    dv3.main(["--device", "cpu", *tiny])
    ckpt = str(tmp_path / "r" / "checkpoints" / "ckpt_20")
    on_cpu, on_card = load_checkpoint(ckpt), load_checkpoint(ckpt, cuda_device)
    assert on_card["world_model"]["rssm.recurrent_model.rnn.proj.weight"].device.type == "cuda"
    flat_cpu, flat_card = to_host(on_cpu), to_host(on_card)

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, dict):
            return set(a) == set(b) and all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return a == b

    assert same(flat_cpu, flat_card)
    # the sidecar says cpu; on the card the resumed run is told so by its own sidecar
    import json

    sidecar = ckpt + ".args.json"
    cfg = json.load(open(sidecar))
    cfg["device"] = "cuda"
    json.dump(cfg, open(sidecar, "w"))
    dv3.main(["--checkpoint_path", ckpt])
    with open(tmp_path / "r" / "metrics.jsonl") as fh:
        done = [json.loads(line) for line in fh if '"event": "done"' in line][-1]
    assert done["device"].startswith("cuda") and done["resumed"]["start_step"] == 21
    assert done["gradient_steps"] == 2 and done["Params/world_model_delta"] > 0


@pytest.mark.cuda
def test_serve_ckpt_loader_on_the_card(cuda_device, tmp_path):
    """`build_policy` with `--ckpt` loads a CPU-written checkpoint onto the
    card; its player's step there gives the actions the CPU player gives."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.policies import build_policy

    dv3.main(["--device", "cpu", "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "1",
              "--cnn_channels_multiplier", "2", "--dense_units", "16", "--hidden_size", "16",
              "--recurrent_state_size", "16", "--stochastic_size", "4", "--discrete_size", "4",
              "--per_rank_batch_size", "2", "--per_rank_sequence_length", "4", "--horizon", "3",
              "--learning_starts", "16", "--total_steps", "20", "--train_every", "2", "--buffer_size", "64",
              "--bins", "15", "--root_dir", str(tmp_path), "--run_name", "r"])
    ckpt = str(tmp_path / "r" / "checkpoints" / "ckpt_20")
    gen = torch.Generator().manual_seed(3)
    obs = torch.randint(0, 256, (1, 64, 64, 3), generator=gen, dtype=torch.uint8)
    actions = []
    for device in (torch.device("cpu"), cuda_device):
        policy, player, _ = build_policy(ServeArgs(device=str(device), ckpt=ckpt), device)
        init = policy.init_row(1, player)
        state = {k: v[None] for k, v in init.items()}
        with torch.inference_mode():
            for _ in range(3):
                state, acts = policy.step(player, state, {"rgb": obs.to(device)})
        actions.append(acts.float().cpu())
    assert torch.equal(actions[0], actions[1])


def _ppo_update(device, env: str, seed: int = 0):
    """One PPO update at tiny widths on `device` from the same seeded
    parameters, rollout and permutations. -> (metrics, agent)."""
    import numpy as np

    from sheeprl_tpu_torch.algos.ppo import ppo
    from sheeprl_tpu_torch.algos.ppo.args import PPOArgs
    from sheeprl_tpu_torch.envs import spaces

    pixels = env == "pixels"
    args = PPOArgs(device=str(device), dense_units=16, cnn_features_dim=32, mlp_features_dim=16, update_epochs=2,
                   per_rank_batch_size=8, max_grad_norm=0.5, normalize_advantages=True, ent_coef=0.01,
                   cnn_keys=["rgb"] if pixels else [], mlp_keys=[] if pixels else ["state"])
    space = {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)} if pixels else {"state": spaces.Box(-1, 1, (4,))}
    agent = ppo.build_agent(args, [2], False, space, args.cnn_keys, args.mlp_keys,
                            torch.Generator().manual_seed(seed)).to(device)
    optimizer = ppo.make_optimizer(args, agent)
    gen, n = torch.Generator().manual_seed(seed + 1), 32
    obs = (torch.randint(0, 256, (n, 64, 64, 3), generator=gen, dtype=torch.uint8) if pixels
           else torch.randn(n, 4, generator=gen))
    batch = {"rgb" if pixels else "state": obs,
             "actions": torch.nn.functional.one_hot(torch.randint(0, 2, (n,), generator=gen), 2).float(),
             "logprobs": torch.log(torch.rand(n, 1, generator=gen) * 0.4 + 0.3),
             "values": torch.randn(n, 1, generator=gen), "returns": torch.randn(n, 1, generator=gen) * 3,
             "advantages": torch.randn(n, 1, generator=gen) * 2}
    perms = torch.stack([torch.randperm(n, generator=gen) for _ in range(args.update_epochs)])
    metrics = ppo.make_train_step(args, n // args.per_rank_batch_size)(
        agent, optimizer, {k: v.to(device) for k, v in batch.items()}, 1e-3, 0.2, 0.01, perms=perms)
    return metrics, agent


@pytest.mark.cuda
@pytest.mark.parametrize("env", ["cartpole", "pixels"])
def test_ppo_update_on_the_card_matches_the_cpu(cuda_device, env):
    """One PPO update (8 Adam steps) on the card against the same update on
    the CPU: losses at rtol 1e-3, every parameter to 1e-4 of its largest
    magnitude (f32 sums in other orders, TF32 off)."""
    card, card_agent = _ppo_update(cuda_device, env)
    host, host_agent = _ppo_update(torch.device("cpu"), env)
    for k in host:
        assert abs(card[k] - host[k]) <= 1e-3 * abs(host[k]) + 1e-7, k
    want = host_agent.state_dict()
    for k, p in card_agent.state_dict().items():
        assert float((p.cpu() - want[k]).abs().max()) <= 1e-4 * float(want[k].abs().max()), k


@pytest.mark.cuda
def test_ppo_dry_run_on_cuda(cuda_device, tmp_path):
    """`ppo --dry_run` without `--device` runs on the card: one update, a
    checkpoint, the test episode; `--eval_only` over it with `--device cpu`
    evaluates the card's checkpoint on the CPU."""
    import json

    from sheeprl_tpu_torch.algos.ppo import ppo

    ppo.main(["--env_id", "CartPole-v1", "--dry_run", "--num_envs", "2", "--rollout_steps", "16",
              "--per_rank_batch_size", "8", "--root_dir", str(tmp_path), "--run_name", "r"])
    with open(tmp_path / "r" / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    done = records[-1]
    assert done["device"].startswith("cuda") and done["updates"] == 1 and len(done["test_returns"]) == 1
    ckpt = str(tmp_path / "r" / "checkpoints" / "ckpt_1")
    ppo.main(["--eval_only", "--checkpoint_path", ckpt, "--device", "cpu", "--root_dir", str(tmp_path),
              "--run_name", "eval"])
    with open(tmp_path / "eval" / "metrics.jsonl") as fh:
        done = [json.loads(line) for line in fh][-1]
    assert done["device"] == "cpu" and done["updates"] == 0


# ---------------------------------------------------------------------------
# CUDA graphs (compile/plan.py): each kernel captured and replayed, the
# graphed entry points against their eager selves
# ---------------------------------------------------------------------------


def _leaves(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _leaves(v)]
    return [t for v in vars(out).values() for t in _leaves(v)]


def _kernel_case(name, dev):
    """(wrapper, its counter, make_args(seed)) of kernel `name` at a path's
    shapes: kernel 1 at rung 8, 2 at the scan's B = 16 and imagination's
    B = 1,024, 3 at rung 8's first stage, 3-res and 4 at training stages,
    5 at the CartPole path's widths in bf16 (cooperative launch), 6 at
    Pendulum's trunk (cluster launch), 7 at the critic loss's shape."""
    def gen_of(seed):
        return torch.Generator().manual_seed(seed)

    def gru_args(batch):
        def make(seed):
            g = gen_of(seed)
            return (_rand(g, batch, 512).to(dev), torch.tanh(_rand(g, batch, 512)).to(dev),
                    _rand(g, 1536, 1024, scale=0.03).to(dev), (1.0 + _rand(g, 1536, scale=0.1)).to(dev),
                    _rand(g, 1536, scale=0.1).to(dev), 1e-5)
        return make

    def conv_args(n, cin, cout, size):
        def make(seed):
            g = gen_of(seed)
            return (torch.rand(n, size, size, cin, generator=g).to(dev), _rand(g, 4, 4, cin, cout, scale=0.05).to(dev),
                    (1.0 + _rand(g, cout, scale=0.1)).to(dev), _rand(g, cout, scale=0.1).to(dev), 1e-3)
        return make

    def deconv_args(seed):
        g = gen_of(seed)
        return (_rand(g, 64, 8, 8, 128).to(dev), _rand(g, 4, 4, 128, 64, scale=0.03).to(dev),
                (1.0 + _rand(g, 64, scale=0.1)).to(dev), _rand(g, 64, scale=0.1).to(dev), 1e-3)

    def rssm_args(seed):
        return (*_rssm_inputs(gen_of(seed), dev, torch.bfloat16, 16), "silu", (1e-3, 1e-5, 1e-3))

    def int8_args(seed):
        x, tensors = _int8_trunk(gen_of(seed), (3, 256, 256, 1), 8)
        return (x.to(dev), *[t.to(dev) for t in tensors])

    def two_hot_args(seed):
        g = gen_of(seed)
        return ((8.0 * _rand(g, 15360, 1)).to(dev), _rand(g, 15360, 255, scale=2.0).to(dev),
                torch.linspace(-20.0, 20.0, 255, device=dev)[None])

    def symlog_args(seed):
        return ((_rand(gen_of(seed), 1024, 255) * 10).to(dev),)

    cases = {
        "1_gru": (gru.layernorm_gru_cell, gru.layernorm_gru_cell, gru_args(8)),
        "2_gru_residuals_b16": (gru.layernorm_gru_cell_residuals, gru.layernorm_gru_cell_residuals, gru_args(16)),
        "2_gru_residuals_b1024": (gru.layernorm_gru_cell_residuals, gru.layernorm_gru_cell_residuals,
                                  gru_args(1024)),
        "3_conv": (cnn.conv_ln_silu, cnn.conv_ln_silu, conv_args(8, 3, 32, 64)),
        "3res_conv_residuals": (cnn.conv_ln_silu_residuals, cnn.conv_ln_silu_residuals, conv_args(64, 32, 64, 32)),
        # the gray encoder's first stage (Cin = 1, K = 16): the player's 4
        # envs and the gradient step's T * B = 1,024 frames
        "3_conv_cin1": (cnn.conv_ln_silu, cnn.conv_ln_silu, conv_args(4, 1, 32, 64)),
        "3res_conv_residuals_cin1": (cnn.conv_ln_silu_residuals, cnn.conv_ln_silu_residuals,
                                     conv_args(1024, 1, 32, 64)),
        "4_deconv": (deconv.deconv_ln_silu, deconv.deconv_ln_silu, deconv_args),
        "5_fused_rssm": (rssm.fused_rssm_step, rssm.fused_rssm_step, rssm_args),
        "6_int8_trunk": (int8_trunk.fused_int8_trunk, int8_trunk.fused_int8_trunk, int8_args),
        "7_two_hot": (two_hot.two_hot_log_prob, two_hot.two_hot_log_prob, two_hot_args),
        "8_symlog": (symlog.symlog, symlog.symlog, symlog_args),
    }
    return cases[name]


KERNEL_GRAPH_CASES = ["1_gru", "2_gru_residuals_b16", "2_gru_residuals_b1024", "3_conv", "3res_conv_residuals",
                      "3_conv_cin1", "3res_conv_residuals_cin1", "4_deconv", "5_fused_rssm", "6_int8_trunk",
                      "7_two_hot", "8_symlog"]
# the kernel each wrapper call launches exactly once, by its name on the device
KERNEL_DEVICE_NAMES = {
    "1_gru": r"gru_row_kernel<[^<>]*, false>", "2_gru_residuals_b16": r"gru_row_kernel<[^<>]*, true>",
    "2_gru_residuals_b1024": r"gru_row_kernel<[^<>]*, true>", "3_conv": r"conv_gemm_kernel<[^<>]*, false, false>",
    "3res_conv_residuals": r"conv_gemm_kernel<[^<>]*, false, true>", "4_deconv": r"conv_gemm_kernel<[^<>]*, true, \w+>",
    "3_conv_cin1": r"conv_gemm_kernel<[^<>]*, false, false>", "3res_conv_residuals_cin1": r"conv_gemm_kernel<[^<>]*, false, true>",
    "5_fused_rssm": r"fused_rssm_kernel<", "6_int8_trunk": r"int8_trunk_kernel<", "7_two_hot": r"two_hot_kernel<",
    "8_symlog": r"symlog_kernel<",
}


def _device_launches(fn, pattern: str) -> int:
    """The kernels matching `pattern` that the device ran during `fn()`, by
    torch.profiler (CUDA activity)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and re.search(pattern, e.name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_GRAPH_CASES)
def test_kernel_captured_in_a_graph_replays_as_its_eager_launch(cuda_device, name):
    """Each kernel inside a CUDA graph: the first call warms up, the plan
    captures (kernel 5's cooperative launch, kernels 1/2's programmatic
    dependent launch of the row pass, kernel 6's cluster launch), and a
    replay on new inputs equals the eager launch on them bit for bit. The
    wrapper counts the warm-up's launch and the capture's, never a
    replay's; the device runs the kernel once a replay (torch.profiler)."""
    from sheeprl_tpu_torch.compile.plan import CompilePlan
    from sheeprl_tpu_torch.ops.kernels import launch_counters

    fn, counter, make = _kernel_case(name, cuda_device)
    plan = CompilePlan(device=cuda_device)
    graphed = plan.register(name, fn)
    with torch.no_grad():
        before = counter.launches
        graphed(*make(0))  # eager warm-up, then the capture
        assert counter.launches == before + 2
        args = make(1)
        outs = []
        ran = _device_launches(lambda: outs.extend(graphed(*args) for _ in range(2)), KERNEL_DEVICE_NAMES[name])
        assert counter.launches == before + 2 and ran == 2
        want = fn(*args)
    stats = plan.stats()["entries"][name]
    assert stats["compiled"] and stats["aot_calls"] == 2 and stats["fallbacks"] == 0
    counted = next(k for k, f in launch_counters().items() if f is counter)
    assert stats["launches_per_replay"] == {counted: 1}
    for out in outs:
        for g, w in zip(_leaves(out), _leaves(want)):
            assert torch.equal(g, w), (name, float((g.float() - w.float()).abs().max()))


TINY_DV3 = ["--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "1", "--cnn_channels_multiplier", "2",
            "--dense_units", "16", "--hidden_size", "16", "--recurrent_state_size", "16", "--stochastic_size", "4",
            "--discrete_size", "4", "--per_rank_batch_size", "2", "--per_rank_sequence_length", "4", "--horizon",
            "3", "--learning_starts", "8", "--train_every", "1", "--buffer_size", "64", "--bins", "15"]


@pytest.mark.cuda
def test_graphed_dreamer_v3_run_resumes_on_the_cpu(cuda_device, tmp_path):
    """A DreamerV3 run on the card takes its gradient and player steps as
    graph replays (no fallback); its checkpoint (capturable Adams, step
    counts on the card) resumes on the CPU and trains on from it."""
    import json

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3

    dv3.main([*TINY_DV3, "--total_steps", "16", "--checkpoint_every", "12", "--checkpoint_buffer",
              "--root_dir", str(tmp_path), "--run_name", "r"])
    with open(tmp_path / "r" / "metrics.jsonl") as fh:
        done = [json.loads(line) for line in fh if '"event": "done"' in line][-1]
    stats = done["compile_stats"]["entries"]
    assert done["compile"]["Compile/aot_fallbacks"] == 0
    assert stats["train_step"]["aot_calls"] + stats["train_step"]["eager_calls"] == done["gradient_steps"]
    assert stats["player_step"]["aot_calls"] + stats["player_step"]["eager_calls"] == done["player_steps"]
    assert stats["train_step"]["aot_calls"] > 0 and stats["player_step"]["aot_calls"] > 0
    dv3.main(["--checkpoint_path", str(tmp_path / "r" / "checkpoints" / "ckpt_12"), "--device", "cpu"])
    with open(tmp_path / "r" / "metrics.jsonl") as fh:
        done = [json.loads(line) for line in fh if '"event": "done"' in line][-1]
    assert done["device"] == "cpu" and done["gradient_steps"] == 4 and done["Params/world_model_delta"] > 0


TINY_DV3_CARTPOLE = ["--env_id", "CartPole-v1", "--mlp_keys", "state", "--num_envs", "1", "--dense_units", "16",
                     "--hidden_size", "16", "--recurrent_state_size", "16", "--stochastic_size", "4", "--discrete_size",
                     "4", "--mlp_layers", "2", "--per_rank_batch_size", "2", "--per_rank_sequence_length", "4",
                     "--horizon", "3", "--learning_starts", "8", "--total_steps", "20", "--train_every", "1",
                     "--buffer_size", "64", "--bins", "15", "--critic_target_network_update_freq", "2",
                     "--expl_amount", "0.5", "--expl_decay", "--max_step_expl_decay", "4"]
TINY_PPO = ["--env_id", "CartPole-v1", "--num_envs", "2", "--rollout_steps", "8", "--per_rank_batch_size", "4",
            "--update_epochs", "2", "--total_steps", "48", "--dense_units", "16", "--mlp_features_dim", "16",
            "--anneal_lr", "--anneal_clip_coef", "--anneal_ent_coef", "--ent_coef", "0.01"]


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["dreamer_v3", "ppo"])
def test_warm_compile_on_equals_off_bit_for_bit(cuda_device, tmp_path, algo):
    """`--warm_compile on` warms each step up on example arguments and
    captures it before the loop, then puts back what the warm-up changed
    (parameters, buffers, the Adams' state, the return normaliser through
    its `state_dict`); the run must go on as `off` does, where each step
    is captured at its first call: the same records and the same final
    state, bit for bit (graph replays both ways, no fallback). No convs, so
    that two eager runs agree bit for bit."""
    import json

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.ppo import ppo

    main, argv, last = (dv3.main, TINY_DV3_CARTPOLE, "ckpt_20") if algo == "dreamer_v3" else (ppo.main, TINY_PPO,
                                                                                              "ckpt_3")
    records, states = {}, {}
    for warm in ("off", "on"):
        main([*argv, "--warm_compile", warm, "--root_dir", str(tmp_path), "--run_name", warm])
        with open(tmp_path / warm / "metrics.jsonl") as fh:
            lines = [json.loads(line) for line in fh if line.strip()]
        done = lines[-1]
        # the losses of every update, the test episodes' returns
        records[warm] = [{k: v for k, v in r.items() if k != "sps" and not k.startswith("Time/")} for r in lines
                         if any(k.startswith("Loss/") for k in r)] + [done["test_returns"]]
        states[warm] = torch.load(tmp_path / warm / "checkpoints" / last / "state.pt", map_location="cpu",
                                  weights_only=False)
        assert done["compile"]["Compile/aot_fallbacks"] == 0 and done["compile"]["Compile/aot_calls"] > 0
        assert done["compile"]["Compile/warm_enabled"] == float(warm == "on")
    assert len(records["off"]) > 2 and records["on"] == records["off"]

    def leaves(tree, path=""):
        if isinstance(tree, torch.Tensor):
            yield path, tree
        elif isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from leaves(tree[k], f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")

    on, off = dict(leaves(states["on"])), dict(leaves(states["off"]))
    assert on.keys() == off.keys() and len(on) > 10
    assert [k for k in on if not torch.equal(on[k], off[k])] == []


def _serve_thread(argv, root):
    import os
    import threading
    import time

    from sheeprl_tpu_torch.cli import run

    failures = []

    def _run():
        try:
            run(["serve", *argv, "--root_dir", root, "--run_name", "s", "--deadline_ms", "0"])
        except BaseException as err:  # reported by the caller
            failures.append(err)

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    addr = os.path.join(root, "s", "serve_address")
    deadline = time.monotonic() + 300
    while not os.path.exists(addr):
        assert not failures and time.monotonic() < deadline, failures
        time.sleep(0.05)
    return open(addr).read().strip(), t, failures


@pytest.mark.cuda
def test_graphed_serve_reload_moves_the_answers_and_keeps_sessions(cuda_device, tmp_path):
    """`serve --ckpt` on the card at a tiny width: each dispatch is a graph
    replay; a RELOAD moves the graphed rung's answers to the new version
    (each answer equal to a direct step of the loaded params); a session's
    row survives the next dispatch, which overwrites the graph's outputs."""
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.policies import build_policy

    dv3.main(["--device", "cpu", *TINY_DV3, "--total_steps", "16", "--checkpoint_every", "12",
              "--root_dir", str(tmp_path), "--run_name", "r"])
    first, second = (str(tmp_path / "r" / "checkpoints" / f"ckpt_{s}") for s in (12, 16))
    rng = np.random.default_rng(0)
    obs = [rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8) for _ in range(12)]
    addr, t, failures = _serve_thread(["--ckpt", first, "--max_batch", "2", "--serve_requests", "12"],
                                      str(tmp_path / "serve"))
    answers = []
    with ServeClient(addr) as client:
        for i, o in enumerate(obs):
            if i == 6:
                assert client.reload(second)["version"] == 2
            # sessions a and b alternate: each dispatch overwrites the rung's
            # outputs while the other session's row waits in the table
            answers.append(client.request({"rgb": o}, session="ab"[i % 2])[0]["actions"])
    t.join(120)
    assert not failures and not t.is_alive()
    policy, player1, loader = build_policy(ServeArgs(ckpt=first), cuda_device)
    player2 = loader(second)
    states = {}
    for i, o in enumerate(obs):
        player = player1 if i < 6 else player2  # the rows the sessions hold carry over the reload
        sid = "ab"[i % 2]
        if sid not in states:
            states[sid] = {k: v[None] for k, v in policy.init_row(1, player1).items()}
        with torch.inference_mode():
            states[sid], acts = policy.step(player, states[sid], {"rgb": torch.from_numpy(o).to(cuda_device)})
        assert np.array_equal(answers[i], acts.float().cpu().numpy()), i
    import json
    import os

    with open(os.path.join(tmp_path, "serve", "s", "telemetry.jsonl")) as fh:
        gauges = [json.loads(line) for line in fh if '"interval"' in line][-1]["metrics"]
    assert gauges["Compile/aot_calls"] >= 12 and gauges["Compile/aot_fallbacks"] == 0


# ---------------------------------------------------------------------------
# the port's Adam and the SAC / DroQ steps on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_adam_on_the_card_matches_its_cpu_run(cuda_device):
    """`ops/optim.py:Adam` runs the same f32 arithmetic on both devices
    (step counts are device tensors on each): 100 steps of the same
    gradients from the same parameters, clipped at 1.0, on the card (the
    step captured in a CUDA graph and replayed) and on the CPU. The
    parameters and moments must agree to 1e-6 (the card's `powf`, `sqrtf`
    and divisions against the CPU's; the gap is printed)."""
    from sheeprl_tpu_torch.compile.plan import CompilePlan
    from sheeprl_tpu_torch.ops.optim import Adam, apply_gradients

    gen = torch.Generator().manual_seed(0)
    shapes = [(64, 32), (32,), (8, 4, 2), (1,)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) * (10.0 if i % 7 == 0 else 0.1) for s in shapes] for i in range(100)]
    # a module holds the parameters: a graphed step's tensor arguments are
    # copied into its own inputs, its modules taken as they are
    params = {d: torch.nn.ParameterList([p.clone().to(d) for p in init]) for d in ("cpu", cuda_device)}
    opts = {d: Adam(ps.parameters(), lr=3e-4, eps=1e-4) for d, ps in params.items()}

    def step(module, opt, gs):
        apply_gradients(list(module.parameters()), gs, opt, 1.0)

    graphed = CompilePlan(device=cuda_device).register("adam", step)
    for gs in grads:
        step(params["cpu"], opts["cpu"], gs)
        graphed(params[cuda_device], opts[cuda_device], [g.to(cuda_device) for g in gs])
    gaps = []
    for a, b in zip(params["cpu"].parameters(), params[cuda_device].parameters()):
        sa, sb = opts["cpu"].state[a], opts[cuda_device].state[b]
        assert sb["step"].device.type == "cuda" and float(sb["step"]) == float(sa["step"]) == 100
        for x, y in ((a, b), (sa["exp_avg"], sb["exp_avg"]), (sa["exp_avg_sq"], sb["exp_avg_sq"])):
            gaps.append(float((x.detach() - y.detach().cpu()).abs().max()))
    print(f"Adam, 100 steps, card vs CPU: largest gap {max(gaps):.3e}")
    assert max(gaps) <= 1e-6, gaps


def _sac_case(algo: str, device, seed: int = 0):
    """A SAC or DroQ agent, its Adams, its train step and the inputs of
    three calls at width 64, B 32, G 3, on `device`."""
    from sheeprl_tpu_torch.algos.droq.args import DROQArgs
    from sheeprl_tpu_torch.algos.droq.droq import build_agent as droq_agent
    from sheeprl_tpu_torch.algos.droq.droq import droq_draws
    from sheeprl_tpu_torch.algos.droq.droq import make_train_step as droq_step
    from sheeprl_tpu_torch.algos.sac.args import SACArgs
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainState, build_agent, make_optimizers, make_train_step, sac_draws

    kw = dict(gradient_steps=3, per_rank_batch_size=32, actor_hidden_size=64, critic_hidden_size=64,
              device=str(device))
    if algo == "sac":
        args = SACArgs(**kw)
        agent, layout, step = build_agent, sac_draws(args, 1), make_train_step
    else:
        args = DROQArgs(**kw, dropout=0.1)
        agent, layout, step = droq_agent, droq_draws(args, 1), droq_step
    low, high = torch.full((1,), -2.0).numpy(), torch.full((1,), 2.0).numpy()
    a = agent(args, 3, 1, low, high, torch.Generator().manual_seed(seed)).to(device)
    state = SACTrainState(a, *make_optimizers(args, a))
    gen = torch.Generator().manual_seed(seed + 1)
    calls = []
    for i in range(3):
        data = {k: torch.randn(3, 32, n, generator=gen).to(device) for k, n in
                (("observations", 3), ("next_observations", 3), ("actions", 1), ("rewards", 1))}
        data["dones"] = (torch.rand(3, 32, 1, generator=gen) < 0.1).float().to(device)
        draws = layout.fill(layout.new("cpu"), gen).to(device)
        extra = (torch.tensor(i != 1, device=device) if algo == "sac"
                 else torch.randn(32, 3, generator=gen).to(device))
        calls.append((state, data, draws, extra))
    return step(args, layout), calls, state


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["sac", "droq"])
def test_graphed_sac_train_and_policy_steps_equal_eager_bit_for_bit(cuda_device, algo):
    """The train step (three Adams, the EMA gate as a device bool, DroQ's
    dropout draws passed in) and the policy step, each graphed by the
    plan (first call eager, then capture and replays) against the same
    calls made eagerly from the same state: losses, actions and every
    parameter, target and Adam moment bit for bit, no fallback."""
    from sheeprl_tpu_torch.algos.sac.sac import policy_step
    from sheeprl_tpu_torch.compile.plan import CompilePlan

    results = {}
    for graphed in (False, True):
        step, calls, state = _sac_case(algo, cuda_device)
        plan = CompilePlan(device=cuda_device)
        train = plan.register("train_step", step) if graphed else step
        policy = plan.register("policy_step", policy_step) if graphed else policy_step
        gen = torch.Generator().manual_seed(9)
        outs = []
        for call in calls:
            outs.append(train(*call).clone())
            obs, noise = torch.randn(4, 3, generator=gen).to(cuda_device), torch.randn(4, 1, generator=gen)
            outs.append(policy(state.agent.actor, obs, noise.to(cuda_device)).clone())
        torch.cuda.synchronize()
        moments = [t.clone() for opt in (state.qf_opt, state.actor_opt, state.alpha_opt)
                   for st in opt.state.values() for t in st.values()]
        results[graphed] = (outs, {k: v.clone() for k, v in state.agent.state_dict().items()}, moments)
        if graphed:
            stats = plan.stats()["entries"]
            assert all(e["fallbacks"] == 0 and e["aot_calls"] == 2 for e in stats.values()), stats
    (eo, es, em), (go, gs, gm) = results[False], results[True]
    assert all(torch.equal(a, b) for a, b in zip(eo, go))
    assert es.keys() == gs.keys() and [k for k in es if not torch.equal(es[k], gs[k])] == []
    assert len(em) == len(gm) and all(torch.equal(a, b) for a, b in zip(em, gm))


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["sac", "droq"])
def test_graphed_sac_run_on_the_card_resumes_on_the_cpu(cuda_device, tmp_path, algo):
    """`sac` / `droq` on the card at tiny widths (the train and policy steps
    graph replays, no fallback), its checkpoint resumed with `--device cpu`
    (the Adams' step counts moved to the CPU, the card's generator state
    reseeded) and evaluated there."""
    import json

    from sheeprl_tpu_torch.cli import run

    argv = [algo, "--num_envs", "1", "--actor_hidden_size", "16", "--critic_hidden_size", "16",
            "--per_rank_batch_size", "8", "--learning_starts", "16", "--buffer_size", "128", "--gradient_steps",
            "2", "--root_dir", str(tmp_path), "--run_name", "r"]
    run([*argv, "--total_steps", "48", "--checkpoint_every", "24"])

    def done():
        with open(tmp_path / "r" / "metrics.jsonl") as fh:
            return [json.loads(line) for line in fh][-1]

    rec = done()
    stats = rec["compile_stats"]["entries"]
    assert stats["train_step"]["aot_calls"] == rec["train_calls"] - 1 and stats["train_step"]["fallbacks"] == 0
    assert stats["policy_step"]["fallbacks"] == 0 and stats["policy_step"]["aot_calls"] > 0
    run([algo, "--checkpoint_path", str(tmp_path / "r" / "checkpoints" / "ckpt_24"), "--device", "cpu"])
    rec = done()
    assert rec["device"] == "cpu" and rec["resumed"]["start_step"] == 25 and rec["env_steps"] == 24


# ---------------------------------------------------------------------------
# the device envs and the Anakin collectors (`envs/device/`) on the card
# ---------------------------------------------------------------------------

ENV_LIMITS = {"CartPole-v1": 500, "Pendulum-v1": 200, "pixeltoy": 128}


def _device_env_states(env_id: str, n: int, gen: torch.Generator):
    """n random states of the env (some a step short of the time limit), on the CPU."""
    from sheeprl_tpu_torch.envs.device import CartPoleState, PendulumState, PixelToyState

    t = torch.randint(0, ENV_LIMITS[env_id], (n,), generator=gen, dtype=torch.int32)
    t[:4] = ENV_LIMITS[env_id] - 1
    if env_id == "CartPole-v1":
        return CartPoleState(state=torch.randn(n, 4, generator=gen) * torch.tensor([1.0, 1.5, 0.1, 1.5]), t=t)
    if env_id == "Pendulum-v1":
        u = torch.rand(n, 2, generator=gen) * 2 - 1
        return PendulumState(state=u * torch.tensor([7.0, 8.0]), t=t)
    cells = torch.randint(0, 16, (2, n, 2), generator=gen, dtype=torch.int32)
    return PixelToyState(agent=cells[0], goal=cells[1], t=t)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["CartPole-v1", "Pendulum-v1", "pixeltoy"])
def test_device_env_step_on_the_card_matches_the_cpu(cuda_device, env_id):
    """Each device env's step on the card from the CPU's states, every
    action: observations and rewards to 1e-6 (or two f32 ulps of a value
    past 4; the card's `sin`/`cos` may round an ulp apart), pixeltoy's
    frames and every flag exactly."""
    from sheeprl_tpu_torch.envs.device import make_device_env
    from sheeprl_tpu_torch.envs.device.core import tree_map

    env = make_device_env(env_id)
    state = _device_env_states(env_id, 256, torch.Generator().manual_seed(0))
    card_state = tree_map(lambda x: x.to(cuda_device), state)
    if env_id == "Pendulum-v1":
        actions = [torch.full((256, 1), u) for u in (-3.0, -2.0, -0.7, 0.0, 0.3, 1.999, 2.5)]
    else:
        actions = [torch.full((256,), a, dtype=torch.int32) for a in range(2 if env_id == "CartPole-v1" else 5)]
    for a in actions:
        want = env.step(state, a)
        got = env.step(card_state, a.to(cuda_device))
        w_leaves, g_leaves = [], []
        for w, g in ((want[0], got[0]), (want[1], got[1]), (want[2], got[2]), (want[3], got[3]), (want[4], got[4])):
            tree_map(lambda x, y: (w_leaves.append(x), g_leaves.append(y.cpu())), w, g)
        for w, g in zip(w_leaves, g_leaves):
            assert g.dtype == w.dtype and g.shape == w.shape
            if w.is_floating_point() and env_id != "pixeltoy":
                torch.testing.assert_close(g, w, atol=1e-6, rtol=2.4e-7)
            else:
                assert torch.equal(g, w), env_id


def _ppo_collector_case(env_id: str, device):
    from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent
    from sheeprl_tpu_torch.algos.ppo.ppo import actions_dim_of
    from sheeprl_tpu_torch.envs.device import VecDeviceEnv, make_device_env
    from sheeprl_tpu_torch.envs.device.rollout import PPOCollectorCarry, make_ppo_collector

    venv = VecDeviceEnv(make_device_env(env_id), 16, device)
    space = venv.single_observation_space.spaces
    actions_dim, cont = actions_dim_of(venv.single_action_space)
    cnn = [k for k, s in space.items() if len(s.shape) == 3]
    agent = PPOAgent(actions_dim, space, cnn, [k for k in space if k not in cnn], dense_units=16, mlp_features_dim=16,
                     cnn_features_dim=32, is_continuous=cont, generator=torch.Generator().manual_seed(0)).to(device)
    carry = PPOCollectorCarry.reset(venv, torch.Generator(device=device).manual_seed(1))

    def draws(gen):
        return venv.draw_resets(gen, 8), agent.draw_noise(gen, 8, 16)

    return make_ppo_collector(venv, 8, actions_dim, cont), (agent, carry), draws, carry


def _dreamer_collector_case(random_phase: bool, device):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3, build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import make_device_preprocess
    from sheeprl_tpu_torch.envs.device import VecDeviceEnv, make_device_env
    from sheeprl_tpu_torch.envs.device.rollout import (
        DreamerCollectorCarry, make_dreamer_collector, random_action_sampler,
    )

    venv = VecDeviceEnv(make_device_env("pixeltoy", max_episode_steps=6), 4, device)
    args = DreamerV3Args(cnn_channels_multiplier=2, dense_units=16, hidden_size=16, recurrent_state_size=16,
                         stochastic_size=4, discrete_size=4)
    wm, actor, _, _ = build_models(torch.Generator().manual_seed(0), [5], False, args,
                                   venv.single_observation_space.spaces, ["rgb"], [])
    player = PlayerDV3(wm.encoder, wm.rssm, actor, actions_dim=[5], stochastic_size=4, discrete_size=4,
                       recurrent_state_size=16).to(device)
    with torch.no_grad():
        pstate = player.init_states(4)
    carry = DreamerCollectorCarry.reset(venv, torch.Generator(device=device).manual_seed(1))
    sampler = random_action_sampler(venv.single_action_space, [5], False)

    def draws(gen):
        fresh = venv.draw_resets(gen, 6)
        if random_phase:
            return fresh, sampler(gen, 6, 4), torch.zeros((), device=device)
        return fresh, torch.rand((6, 4, player.noise_width()), generator=gen, device=device), torch.full(
            (), 0.3, device=device)

    collect = make_dreamer_collector(venv, 6, [5], False, make_device_preprocess(["rgb"]), clip_rewards=True,
                                     random_actions=random_phase)
    return collect, (player, pstate, carry), draws, (pstate, carry)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ppo CartPole-v1", "ppo Pendulum-v1", "ppo pixeltoy", "dreamer policy",
                                  "dreamer random"])
def test_graphed_collectors_equal_eager_bit_for_bit(cuda_device, case):
    """A collector registered with the plan (`adopt=True`: the graph reads
    and writes the carry's own tensors) against the same calls made
    eagerly from the same carry and draws: every trajectory, episode dict
    and the final carry (and the player's state) bit for bit over three
    rollouts, each after the first a replay, no fallback."""
    from sheeprl_tpu_torch.compile.plan import CompilePlan
    from sheeprl_tpu_torch.envs.device.core import tree_state_dict

    results = {}
    for graphed in (False, True):
        kind, arg = case.split()
        fn, fixed, draws, state = (_ppo_collector_case(arg, cuda_device) if kind == "ppo"
                                   else _dreamer_collector_case(arg == "random", cuda_device))
        plan = CompilePlan(device=cuda_device)
        collect = plan.register("anakin_rollout", fn, adopt=True) if graphed else fn
        gen = torch.Generator(device=cuda_device).manual_seed(2)
        outs = []
        for _ in range(3):
            traj, ep = collect(*fixed, *draws(gen))
            outs += [traj[k].clone() for k in sorted(traj)] + [ep[k].clone() for k in sorted(ep)]
        torch.cuda.synchronize()
        outs += [v.clone() for _, v in sorted(tree_state_dict(state).items())]
        results[graphed] = outs
        if graphed:
            entry = plan.stats()["entries"]["anakin_rollout"]
            assert entry["fallbacks"] == 0 and entry["aot_calls"] == 2 and entry["compiled"], entry
    assert len(results[False]) == len(results[True])
    assert all(torch.equal(a, b) for a, b in zip(results[False], results[True]))


@pytest.mark.cuda
def test_ppo_and_dreamer_v3_jax_backend_on_the_card(cuda_device, tmp_path):
    """`ppo` and `dreamer_v3 --env_backend jax` without `--device` run on the
    card: every rollout or chunk after the first a replay of its
    "anakin_rollout" entry, no fallback."""
    import json

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.ppo import ppo

    def done(name):
        with open(tmp_path / name / "metrics.jsonl") as fh:
            return [json.loads(line) for line in fh if '"event": "done"' in line][-1]

    ppo.main(["--env_id", "CartPole-v1", "--env_backend", "jax", "--num_envs", "64", "--rollout_steps", "16",
              "--per_rank_batch_size", "256", "--update_epochs", "2", "--total_steps", str(3 * 64 * 16),
              "--root_dir", str(tmp_path), "--run_name", "ppo"])
    rec = done("ppo")
    entry = rec["compile_stats"]["entries"]["anakin_rollout"]
    assert rec["device"].startswith("cuda") and rec["updates"] == 3 and entry["aot_calls"] == 2
    assert entry["fallbacks"] == 0 and rec["anakin"]["Anakin/rollouts"] == 3
    dv3.main(["--env_id", "pixeltoy", "--env_backend", "jax", "--num_envs", "4", "--cnn_channels_multiplier", "2",
              "--dense_units", "16", "--hidden_size", "16", "--recurrent_state_size", "16", "--stochastic_size", "4",
              "--discrete_size", "4", "--per_rank_batch_size", "2", "--per_rank_sequence_length", "4", "--horizon",
              "3", "--learning_starts", "16", "--total_steps", "48", "--train_every", "8", "--buffer_size", "64",
              "--root_dir", str(tmp_path), "--run_name", "dv3"])
    rec = done("dv3")
    stats = rec["compile_stats"]["entries"]
    assert rec["device"].startswith("cuda") and rec["gradient_steps"] == 5 and rec["compile"]["Compile/aot_fallbacks"] == 0
    assert stats["anakin_rollout"]["aot_calls"] == 3 and stats["anakin_rollout_random"]["aot_calls"] == 1


# ---------------------------------------------------------------------------
# DreamerV3 with continuous actions on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_gru_input_gradients_with_frozen_weights_match_plain_autograd(cuda_device):
    """Imagination's backward, where a continuous actor's loss reaches the
    RSSM's recurrent step through the actions: `_LayerNormGRU.backward`'s
    dx/dh branch with w, scale and offset frozen, at B = 1,024 and
    DreamerV3's full width (Dx = 512 from the recurrent MLP, H = 512),
    after the residual kernel's forward, against autograd through the
    plain version; each gradient to 1e-4 of its largest magnitude, and no
    weight gradient formed."""
    gen = torch.Generator().manual_seed(3)
    batch, dx, hidden = 1024, 512, 512
    x = _rand(gen, batch, dx).to(cuda_device).requires_grad_()
    h = torch.tanh(_rand(gen, batch, hidden)).to(cuda_device).requires_grad_()
    w = _rand(gen, 3 * hidden, dx + hidden, scale=(dx + hidden) ** -0.5).to(cuda_device)
    scale = (1.0 + _rand(gen, 3 * hidden, scale=0.1)).to(cuda_device)
    offset = _rand(gen, 3 * hidden, scale=0.1).to(cuda_device)
    g = _rand(gen, batch, hidden).to(cuda_device)
    before = gru.layernorm_gru_cell_residuals.launches
    out = gru.layernorm_gru_cell(x, h, w, scale, offset, 1e-5)
    assert out.grad_fn is not None and gru.layernorm_gru_cell_residuals.launches == before + 1
    got = torch.autograd.grad(out, (x, h), g)
    xp, hp = x.detach().clone().requires_grad_(), h.detach().clone().requires_grad_()
    want = torch.autograd.grad(gru.layernorm_gru_cell_plain(xp, hp, w, scale, offset, 1e-5), (xp, hp), g)
    for name, a, b in zip(("dx", "dh"), got, want):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max(), name
    assert w.grad is None and scale.grad is None and offset.grad is None


TINY_CONTINUOUS = dict(dense_units=16, hidden_size=16, recurrent_state_size=16, stochastic_size=4, discrete_size=4,
                       mlp_layers=2, per_rank_batch_size=2, per_rank_sequence_length=4, horizon=3, bins=15)


def _continuous_train_case(device):
    """A tiny continuous DreamerV3 on Pendulum-v1's 3-vector (no convs, so
    that two eager runs agree bit for bit): its state on `device` and three
    calls' batches and draws."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.ops.moments import Moments

    args = DreamerV3Args(**TINY_CONTINUOUS)
    models = build_models(torch.Generator().manual_seed(0), [1], True, args,
                          {"state": spaces.Box(-float("inf"), float("inf"), (3,))}, [], ["state"])
    for m in models:
        m.to(device)
    state = dv3.DV3TrainState(*models, *dv3.make_optimizers(args, *models[:3]), Moments(device=device))
    gen = torch.Generator().manual_seed(1)
    T, B = args.per_rank_sequence_length, args.per_rank_batch_size
    calls = []
    for tau in (1.0, 0.02, 0.02):
        data = {"state": torch.randn(T, B, 3, generator=gen), "actions": torch.rand(T, B, 1, generator=gen) * 2 - 1,
                "rewards": torch.randn(T, B, 1, generator=gen), "dones": torch.zeros(T, B, 1),
                "is_first": torch.zeros(T, B, 1)}
        data["dones"][1, 0], data["is_first"][2, 0] = 1.0, 1.0
        noise = dv3.draw_noise(args, T, B, [1], gen, "cpu", True)
        noise = {k: v.to(device) for k, v in noise.items()}
        calls.append(({k: v.to(device) for k, v in data.items()}, torch.full((), tau, device=device), noise))
    return args, state, calls


@pytest.mark.cuda
def test_graphed_continuous_train_step_equals_eager_bit_for_bit(cuda_device):
    """The continuous gradient step (the actor's loss through the imagined
    steps, kernel 2's backward on the dx/dh branch) registered with the plan
    against the same three calls made eagerly from the same state: the
    metrics, every parameter, Adam moment and the return normaliser bit for
    bit, no fallback."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.compile.plan import CompilePlan

    results = {}
    for graphed in (False, True):
        args, state, calls = _continuous_train_case(cuda_device)
        plan = CompilePlan(device=cuda_device) if graphed else None
        step = dv3.make_train_step(args, [], ["state"], [1], True, plan=plan).device_step
        outs = [step(state, data, tau, noise).clone() for data, tau, noise in calls]
        torch.cuda.synchronize()
        params = [t.detach().clone() for m in (state.world_model, state.actor, state.critic, state.target_critic)
                  for t in m.state_dict().values()]
        moments = [t.clone() for opt in (state.world_opt, state.actor_opt, state.critic_opt)
                   for st in opt.state.values() for t in st.values()]
        results[graphed] = outs + params + moments + [state.moments.low.clone(), state.moments.high.clone()]
        if graphed:
            entry = plan.stats()["entries"]["train_step"]
            assert entry["fallbacks"] == 0 and entry["aot_calls"] == 2 and entry["compiled"], entry
    assert torch.isfinite(results[False][0]).all() and len(results[False]) == len(results[True])
    assert [i for i, (a, b) in enumerate(zip(results[False], results[True])) if not torch.equal(a, b)] == []


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["exploring", "task"])
@pytest.mark.parametrize("algo", ["p2e_dv2", "p2e_dv1"])
def test_graphed_p2e_steps_equal_eager_bit_for_bit(cuda_device, algo, program):
    """Plan2Explore's gradient step of each program (the exploring one: the
    ensemble's fit, the intrinsic reward, both behaviours; the task one)
    and the player step of its behaviour registered with the plan against
    the same three calls made eagerly from the same state (pixels, cuDNN's
    deterministic algorithms): the metrics, every parameter (the target
    critics and the ensemble too) and Adam moment, the player's states and
    actions bit for bit; no fallback and no port kernel captured."""
    import numpy as np

    from sheeprl_tpu_torch.compile.plan import CompilePlan
    from sheeprl_tpu_torch.envs import spaces

    exploring = program == "exploring"
    continuous = algo == "p2e_dv1"
    if algo == "p2e_dv2":
        from sheeprl_tpu_torch.algos.p2e_dv2 import agent, p2e_dv2 as mod
        from sheeprl_tpu_torch.algos.p2e_dv2.args import P2EDV2Args as Args
        fam = mod.P2E_DV2
    else:
        from sheeprl_tpu_torch.algos.p2e_dv1 import agent, p2e_dv1 as mod
        from sheeprl_tpu_torch.algos.p2e_dv1.args import P2EDV1Args as Args
        fam = mod.P2E_DV1
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        results = {}
        for graphed in (False, True):
            args = Args(cnn_channels_multiplier=4, dense_units=32, hidden_size=32, recurrent_state_size=32,
                        stochastic_size=4, mlp_layers=2, num_ensembles=3, per_rank_batch_size=4,
                        per_rank_sequence_length=8, horizon=4)
            if algo == "p2e_dv2":
                args.discrete_size = 4
            actions = [2] if continuous else [3]
            models = agent.build_models(torch.Generator().manual_seed(0), actions, continuous, args,
                                        {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}, ["rgb"], [])
            for m in models:
                m.to(cuda_device)
            state = fam.state(*models, *fam.make_optimizers(args, *models))
            T, B = args.per_rank_sequence_length, args.per_rank_batch_size
            rng, gen = np.random.default_rng(0), torch.Generator(device=cuda_device).manual_seed(1)
            plan = CompilePlan(device=cuda_device) if graphed else None
            step = mod.make_train_step(args, ["rgb"], [], actions, continuous, plan=plan,
                                       exploring=exploring).device_step
            outs = []
            for tau in (1.0, 0.0, 0.0):
                dones = (rng.random((T, B, 1)) < 0.2).astype(np.float32)
                data = {"rgb": rng.integers(0, 256, (T, B, 64, 64, 3), dtype=np.uint8),
                        "actions": (rng.uniform(-1, 1, (T, B, 2)).astype(np.float32) if continuous
                                    else np.eye(3, dtype=np.float32)[rng.integers(0, 3, (T, B))]),
                        "rewards": rng.normal(size=(T, B, 1)).astype(np.float32), "dones": dones}
                if fam.target_critic:
                    data["is_first"] = np.concatenate([np.ones((1, B, 1), np.float32), dones[:-1]])
                data = {k: torch.from_numpy(v).to(cuda_device) for k, v in data.items()}
                tau_arg = (torch.full((), tau, device=cuda_device),) if fam.target_critic else ()
                noise = fam.draw_noise(args, T, B, actions, gen, cuda_device, continuous, exploring=exploring)
                outs.append(step(state, data, *tau_arg, noise).clone())
            player = fam.player(state.world_model.encoder, state.world_model.rssm,
                                getattr(state, fam.explore_actor if exploring else fam.actor), actions_dim=actions,
                                stochastic_size=args.stochastic_size, discrete_size=getattr(args, "discrete_size", 0),
                                recurrent_state_size=args.recurrent_state_size, is_continuous=continuous)

            def noisy(*a):
                with torch.inference_mode():
                    return player.noisy_step(*a)

            pstep = plan.register("player_step", noisy) if graphed else noisy
            with torch.no_grad():
                pstate = player.init_states(2)
            for expl in (0.3, 0.0, 0.1):
                obs = {"rgb": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
                       .to(cuda_device).float() / 255.0 - 0.5}
                pstate, acts = pstep(pstate, obs, player.draw_noise(2, gen, cuda_device),
                                     torch.full((), expl, device=cuda_device))
                pstate = type(pstate)(**{k: v.clone() for k, v in vars(pstate).items()})
                outs += [acts.clone(), *vars(pstate).values()]
            torch.cuda.synchronize()
            outs += [t.detach().clone() for f in dataclasses.fields(state) if not f.name.endswith("_opt")
                     for t in getattr(state, f.name).state_dict().values()]
            outs += [t.clone() for f in dataclasses.fields(state) if f.name.endswith("_opt")
                     for st in getattr(state, f.name).state.values() for t in st.values()]
            results[graphed] = outs
            if graphed:
                name = f"train_step_{program}"
                assert set(plan.stats()["entries"]) == {name, "player_step"}
                for entry in plan.stats()["entries"].values():
                    assert entry["fallbacks"] == 0 and entry["aot_calls"] == 2 and entry["compiled"], entry
                    assert not any(entry["launches_per_replay"].values()), entry
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    assert torch.isfinite(results[False][0]).all() and len(results[False]) == len(results[True])
    assert [i for i, (a, b) in enumerate(zip(results[False], results[True])) if not torch.equal(a, b)] == []


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["on", "policy"])
def test_graphed_remat_train_step_equals_eager_bit_for_bit(cuda_device, remat):
    """The continuous gradient step under `--remat on` / `policy` (the RSSM
    scan's and imagination's steps checkpointed, recomputed in the
    backward inside the graph) replayed against the same calls made
    eagerly, and against `--remat off`'s eager calls: metrics, parameters,
    Adam moments and the return normaliser bit for bit."""
    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.compile.plan import CompilePlan

    results = {}
    for mode, graphed in (("off", False), (remat, False), (remat, True)):
        args, state, calls = _continuous_train_case(cuda_device)
        args.remat = mode
        plan = CompilePlan(device=cuda_device) if graphed else None
        step = dv3.make_train_step(args, [], ["state"], [1], True, plan=plan).device_step
        outs = [step(state, data, tau, noise).clone() for data, tau, noise in calls]
        torch.cuda.synchronize()
        params = [t.detach().clone() for m in (state.world_model, state.actor, state.critic, state.target_critic)
                  for t in m.state_dict().values()]
        moments = [t.clone() for opt in (state.world_opt, state.actor_opt, state.critic_opt)
                   for st in opt.state.values() for t in st.values()]
        results[(mode, graphed)] = outs + params + moments + [state.moments.low.clone(), state.moments.high.clone()]
        if graphed:
            entry = plan.stats()["entries"]["train_step"]
            assert entry["fallbacks"] == 0 and entry["aot_calls"] == 2 and entry["compiled"], entry
    base = results[("off", False)]
    assert torch.isfinite(base[0]).all()
    for key in ((remat, False), (remat, True)):
        assert [i for i, (a, b) in enumerate(zip(base, results[key])) if not torch.equal(a, b)] == [], key


@pytest.mark.cuda
def test_metric_aggregator_pulls_device_values_in_one_copy(cuda_device, monkeypatch):
    """Metrics left on the card (as the mains leave a graphed step's) are
    resolved at compute time with one device-to-host copy."""
    from sheeprl_tpu_torch.utils.metric import MetricAggregator, MovingAverageMetric

    values = torch.randn(12, generator=torch.Generator().manual_seed(0))
    agg = MetricAggregator()
    agg.add("Window", MovingAverageMetric(window=4))
    for i, v in enumerate(values.to(cuda_device)):
        agg.update("Loss/a" if i % 2 else "Loss/b", v)
        agg.update("Window", v)
    agg.update("Rewards/rew_avg", 1.5)
    pulls = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (pulls.append(self.device), real(self, *a, **k))[1])
    out = agg.compute()
    assert len(pulls) == 1 and pulls[0].type == "cuda"
    host = values.double().tolist()
    assert out["Loss/a"] == pytest.approx(sum(host[1::2]) / 6, rel=1e-12)
    assert out["Window/max"] == max(host[-4:]) and out["Rewards/rew_avg"] == 1.5


@pytest.mark.cuda
def test_graphed_continuous_serve_answers_as_the_direct_step(cuda_device, tmp_path):
    """`serve` of a tiny continuous DreamerV3 (continuous_dummy pixels) on
    the card: each dispatch a graph replay of its rung, each answer a float
    row equal to a direct `PlayerDV3.step` with the server's best-of-100
    uniforms, bit for bit."""
    import json
    import os

    import numpy as np

    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.policies import build_policy

    model = ("--env_id continuous_dummy --cnn_keys rgb --cnn_channels_multiplier 2 --dense_units 16 --hidden_size 16 "
             "--recurrent_state_size 16 --stochastic_size 4 --discrete_size 4")
    rng = np.random.default_rng(0)
    obs = [rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8) for _ in range(8)]
    addr, t, failures = _serve_thread(["--model_argv", model, "--max_batch", "2", "--serve_requests", "8"],
                                      str(tmp_path / "serve"))
    with ServeClient(addr) as client:
        answers = [client.request({"rgb": o}, session="ab"[i % 2])[0]["actions"] for i, o in enumerate(obs)]
    t.join(120)
    assert not failures and not t.is_alive()
    policy, player, _ = build_policy(ServeArgs(model_argv=model), cuda_device)
    states = {}
    for i, o in enumerate(obs):
        sid = "ab"[i % 2]
        states.setdefault(sid, {k: v[None] for k, v in policy.init_row(1, player).items()})
        with torch.inference_mode():
            states[sid], acts = policy.step(player, states[sid], {"rgb": torch.from_numpy(o).to(cuda_device)})
        assert answers[i].dtype == np.float32 and answers[i].shape == (1, 2)
        assert np.array_equal(answers[i], acts.float().cpu().numpy()), i
    with open(os.path.join(tmp_path, "serve", "s", "telemetry.jsonl")) as fh:
        gauges = [json.loads(line) for line in fh if '"interval"' in line][-1]["metrics"]
    assert gauges["Compile/aot_calls"] >= 8 and gauges["Compile/aot_fallbacks"] == 0


def _pendulum_collector_case(device):
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import PlayerDV3, build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import make_device_preprocess
    from sheeprl_tpu_torch.envs.device import VecDeviceEnv, make_device_env
    from sheeprl_tpu_torch.envs.device.rollout import DreamerCollectorCarry, make_dreamer_collector

    venv = VecDeviceEnv(make_device_env("Pendulum-v1", max_episode_steps=5), 16, device)
    args = DreamerV3Args(**TINY_CONTINUOUS)
    wm, actor, _, _ = build_models(torch.Generator().manual_seed(0), [1], True, args,
                                   venv.single_observation_space.spaces, [], ["state"])
    player = PlayerDV3(wm.encoder, wm.rssm, actor, actions_dim=[1], stochastic_size=4, discrete_size=4,
                       recurrent_state_size=16, is_continuous=True).to(device)
    with torch.no_grad():
        pstate = player.init_states(16)
    carry = DreamerCollectorCarry.reset(venv, torch.Generator(device=device).manual_seed(1))

    def draws(gen):
        return (venv.draw_resets(gen, 4), torch.rand((4, 16, player.noise_width()), generator=gen, device=device),
                torch.full((), 0.3, device=device))

    collect = make_dreamer_collector(venv, 4, [1], True, make_device_preprocess([]))
    return collect, (player, pstate, carry), draws, (pstate, carry)


@pytest.mark.cuda
def test_graphed_pendulum_player_chunk_equals_eager_bit_for_bit(cuda_device):
    """DreamerV3's player chunk on the device Pendulum (4 steps of 16 envs,
    the truncated-normal actor's samples and the exploration's normals
    among the chunk's uniforms) registered with the plan (`adopt=True`)
    against the same chunks made eagerly: every trajectory, episode dict,
    the carry and the player's state bit for bit over three chunks, no
    fallback."""
    from sheeprl_tpu_torch.compile.plan import CompilePlan
    from sheeprl_tpu_torch.envs.device.core import tree_state_dict

    results = {}
    for graphed in (False, True):
        fn, fixed, draws, state = _pendulum_collector_case(cuda_device)
        plan = CompilePlan(device=cuda_device)
        collect = plan.register("anakin_rollout", fn, adopt=True) if graphed else fn
        gen = torch.Generator(device=cuda_device).manual_seed(2)
        outs = []
        for _ in range(3):
            traj, ep = collect(*fixed, *draws(gen))
            outs += [traj[k].clone() for k in sorted(traj)] + [ep[k].clone() for k in sorted(ep)]
        torch.cuda.synchronize()
        outs += [v.clone() for _, v in sorted(tree_state_dict(state).items())]
        results[graphed] = outs
        if graphed:
            entry = plan.stats()["entries"]["anakin_rollout"]
            assert entry["fallbacks"] == 0 and entry["aot_calls"] == 2 and entry["compiled"], entry
    assert len(results[False]) == len(results[True])
    assert all(torch.equal(a, b) for a, b in zip(results[False], results[True]))


# ---------------------------------------------------------------------------
# the rest of the serving tier: DreamerV3's int8 twin, the ladder's probe,
# the on-demand profiler window
# ---------------------------------------------------------------------------

TINY_SERVE_MODEL = ("--env_id discrete_dummy --cnn_keys rgb --cnn_channels_multiplier 2 --dense_units 16 "
                    "--hidden_size 16 --recurrent_state_size 16 --stochastic_size 4 --discrete_size 4")


def _tiny_dv3_policy(device):
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.policies import build_policy

    policy, player, _ = build_policy(ServeArgs(model_argv=TINY_SERVE_MODEL, device=str(device)), device)
    return policy, player


@pytest.mark.cuda
def test_graphed_dv3_int8_twin_equals_eager_bit_for_bit(cuda_device, tmp_path):
    """The DreamerV3 int8 twin's rung-8 step captured as serve captures it
    (`adopt=True` on the rung's buffers) replays equal to its eager launch,
    bit for bit, with the GRU (kernel 1) and the four conv stages (kernel
    3) inside the graph."""
    import types

    import numpy as np

    from sheeprl_tpu_torch.compile.plan import CompilePlan
    from sheeprl_tpu_torch.ops.quant import QuantLinear
    from sheeprl_tpu_torch.serve.quant import QuantState

    policy, player = _tiny_dv3_policy(cuda_device)
    twin = QuantState(policy, types.SimpleNamespace(quant_bound=0.05, seed=0, ckpt=None),
                      str(tmp_path)).params_for(1, player)
    assert any(isinstance(m, QuantLinear) for m in twin.modules())
    _, state, obs = policy.example(twin, 8)
    rng = np.random.default_rng(1)

    def step(*a):
        with torch.inference_mode():
            return policy.step(*a)

    plan = CompilePlan(device=cuda_device)
    runner = plan.register("policy_b8", step, adopt=True)
    for i in range(3):
        with torch.inference_mode():
            obs["rgb"].copy_(torch.from_numpy(rng.integers(0, 256, (8, 64, 64, 3), dtype=np.uint8)))
        want_state, want_acts = step(twin, state, obs)
        got_state, got_acts = runner(twin, state, obs)
        torch.cuda.synchronize()
        assert torch.equal(got_acts, want_acts), i
        assert all(torch.equal(got_state[k], want_state[k]) for k in want_state), i
    entry = plan.stats()["entries"]["policy_b8"]
    assert entry["aot_calls"] == 2 and entry["fallbacks"] == 0
    assert entry["launches_per_replay"] == {"layernorm_gru_cell": 1, "conv_ln_silu": 4}


@pytest.mark.cuda
def test_ladder_probe_on_the_card_is_memoized(cuda_device, tmp_path):
    """The ladder's probe on the card: a peak of the arguments' bytes plus
    the allocator's rise during one eager step (above 0), the second sizing
    read from `serve_ladder.json`."""
    import json
    import os

    from sheeprl_tpu_torch.ops.kernels import cnn, gru
    from sheeprl_tpu_torch.serve import ladder

    policy, player = _tiny_dv3_policy(cuda_device)
    store = str(tmp_path / "serve_ladder.json")
    gru.layernorm_gru_cell.launches = cnn.conv_ln_silu.launches = 0
    first = ladder.size_ladder(policy.step, lambda r: policy.example(player, r), [1, 8], "dreamer_v3@serve",
                               store_path=store)
    assert gru.layernorm_gru_cell.launches == 2 and cnn.conv_ln_silu.launches == 8  # one eager step a rung
    args_b = {r: ladder.example_arg_bytes(policy.example(player, r)) for r in (1, 8)}
    for d in first:
        assert d.accepted and d.source == "probe" and d.reason.endswith("(probe)")
        assert d.peak_bytes > args_b[d.rung] > 0
    with open(store) as fh:
        records = list(json.load(fh).values())
    assert len(records) == 2 and all(r["probe"]["rise_bytes"] > 0 for r in records)
    assert all(torch.cuda.get_device_name(cuda_device) in r["key"] for r in records)
    again = ladder.size_ladder(policy.step, lambda r: policy.example(player, r), [1, 8], "dreamer_v3@serve",
                               store_path=store)
    assert gru.layernorm_gru_cell.launches == 2  # no second probe
    assert [d.peak_bytes for d in again] == [d.peak_bytes for d in first]
    assert all(d.reason.endswith("(probe cache)") for d in again) and os.path.getsize(store) > 0


@pytest.mark.cuda
def test_profile_window_on_the_card_traces_a_port_kernel(cuda_device, tmp_path):
    """An on-demand window opened as a PROFILE frame opens it records the
    card's activity: its chrome trace names the GRU kernel launched while
    it was open, from another thread than the window's."""
    import json

    from sheeprl_tpu_torch.telemetry.trace import handle_profile_frame, profile_window

    gen = torch.Generator().manual_seed(0)
    x, h = (_rand(gen, 8, 32).to(cuda_device) for _ in range(2))
    w = _rand(gen, 96, 64, scale=0.1).to(cuda_device)
    scale, offset = torch.ones(96, device=cuda_device), torch.zeros(96, device=cuda_device)
    gru.layernorm_gru_cell(x, h, w, scale, offset, 1e-3)  # built before the window
    reply = handle_profile_frame({"seconds": 30}, str(tmp_path))
    assert reply["ok"] and reply["cuda"]
    assert not handle_profile_frame({"seconds": 1}, str(tmp_path))["ok"]

    def pad():
        # a window on the card can lose the records at its edges
        # (chip_smoke.py:DeviceLaunches): empty kernels take those places
        for _ in range(256):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()

    pad()
    for _ in range(4):
        gru.layernorm_gru_cell(x, h, w, scale, offset, 1e-3)
    pad()
    profile_window().close()
    with open(reply["trace"]) as fh:
        names = [e.get("name", "") for e in json.load(fh)["traceEvents"]]
    assert sum("gru_row_kernel" in n for n in names) >= 4


def _dreamer_case(device, algo: str, continuous: bool, pixels: bool):
    """A small DreamerV2 or V1 train state, three calls' batches and draws
    (on the card, from fixed seeds) and a player with three steps' inputs."""
    import numpy as np

    from sheeprl_tpu_torch.algos.dreamer_v1 import agent as dv1_agent
    from sheeprl_tpu_torch.algos.dreamer_v1 import dreamer_v1 as dv1
    from sheeprl_tpu_torch.algos.dreamer_v1.args import DreamerV1Args
    from sheeprl_tpu_torch.algos.dreamer_v2 import agent as dv2_agent
    from sheeprl_tpu_torch.algos.dreamer_v2 import dreamer_v2 as dv2
    from sheeprl_tpu_torch.algos.dreamer_v2.args import DreamerV2Args
    from sheeprl_tpu_torch.envs import spaces

    v2 = algo == "dreamer_v2"
    agent, mod = (dv2_agent, dv2) if v2 else (dv1_agent, dv1)
    args = (DreamerV2Args if v2 else DreamerV1Args)(
        cnn_channels_multiplier=4, dense_units=32, hidden_size=32, recurrent_state_size=32, stochastic_size=4,
        mlp_layers=2, per_rank_batch_size=4, per_rank_sequence_length=8, horizon=4)
    if v2:
        args.discrete_size = 4
    space = {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)} if pixels else {"state": spaces.Box(-1, 1, (3,))}
    cnn, mlp = (["rgb"], []) if pixels else ([], ["state"])
    actions = [2] if continuous else [3]
    models = agent.build_models(torch.Generator().manual_seed(0), actions, continuous, args, space, cnn, mlp)
    for m in models:
        m.to(device)
    state = (mod.DV2TrainState if v2 else mod.DV1TrainState)(*models, *mod.make_optimizers(args, *models[:3]))
    noise_of = mod.DREAMER_V2.draw_noise if v2 else mod.DREAMER_V1.draw_noise
    T, B = args.per_rank_sequence_length, args.per_rank_batch_size
    rng, gen = np.random.default_rng(0), torch.Generator(device=device).manual_seed(1)
    calls = []
    for tau in (1.0, 0.0, 0.0):
        dones = (rng.random((T, B, 1)) < 0.2).astype(np.float32)
        data = {"rgb": rng.integers(0, 256, (T, B, 64, 64, 3), dtype=np.uint8)} if pixels else \
            {"state": rng.normal(size=(T, B, 3)).astype(np.float32)}
        data["actions"] = (rng.uniform(-1, 1, (T, B, 2)).astype(np.float32) if continuous
                           else np.eye(3, dtype=np.float32)[rng.integers(0, 3, (T, B))])
        data.update(rewards=rng.normal(size=(T, B, 1)).astype(np.float32), dones=dones)
        if v2:
            data["is_first"] = np.concatenate([np.ones((1, B, 1), np.float32), dones[:-1]])
        data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        tau_arg = (torch.full((), tau, device=device),) if v2 else ()
        calls.append((data, *tau_arg, noise_of(args, T, B, actions, gen, device, continuous)))
    player = (agent.PlayerDV2 if v2 else agent.PlayerDV1)(
        models[0].encoder, models[0].rssm, models[1], actions_dim=actions, stochastic_size=args.stochastic_size,
        discrete_size=getattr(args, "discrete_size", 0), recurrent_state_size=args.recurrent_state_size,
        is_continuous=continuous)
    obs = [({"rgb": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)).to(device).float()
             / 255.0 - 0.5} if pixels else {"state": torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32))
                                            .to(device)}) for _ in range(3)]
    return args, state, calls, mod.make_train_step, player, obs, (cnn, mlp, actions)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dreamer_v2 pixels", "dreamer_v2 vector continuous", "dreamer_v1 pixels continuous",
                                  "dreamer_v1 vector"])
def test_graphed_dreamer_v2_v1_steps_equal_eager_bit_for_bit(cuda_device, case):
    """DreamerV2's and V1's gradient step and player step registered with
    the plan against the same three calls made eagerly from the same state
    (cuDNN's deterministic algorithms, as the pixel convolutions' default
    backward does not repeat): the metrics, every parameter and Adam
    moment, the player's states and actions bit for bit; no fallback and no
    port kernel captured (every guard refuses both paths)."""
    from sheeprl_tpu_torch.compile.plan import CompilePlan

    algo, obs_kind = case.split()[:2]
    continuous = case.endswith("continuous")
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        results = {}
        for graphed in (False, True):
            args, state, calls, make_step, player, obs, (cnn, mlp, actions) = _dreamer_case(
                cuda_device, algo, continuous, obs_kind == "pixels")
            plan = CompilePlan(device=cuda_device) if graphed else None
            step = make_step(args, cnn, mlp, actions, continuous, plan=plan).device_step
            outs = [step(state, *call).clone() for call in calls]

            def noisy(*a):
                with torch.inference_mode():
                    return player.noisy_step(*a)

            pstep = plan.register("player_step", noisy) if graphed else noisy
            gen = torch.Generator(device=cuda_device).manual_seed(3)
            with torch.no_grad():
                pstate = player.init_states(2)
            for o, expl in zip(obs, (0.3, 0.0, 0.1)):
                pstate, acts = pstep(pstate, o, player.draw_noise(2, gen, cuda_device),
                                     torch.full((), expl, device=cuda_device))
                pstate = type(pstate)(**{k: v.clone() for k, v in vars(pstate).items()})
                outs += [acts.clone(), *vars(pstate).values()]
            torch.cuda.synchronize()
            params = [t.detach().clone() for m in (state.world_model, state.actor, state.critic)
                      for t in m.state_dict().values()]
            moments = [t.clone() for opt in (state.world_opt, state.actor_opt, state.critic_opt)
                       for st in opt.state.values() for t in st.values()]
            results[graphed] = outs + params + moments
            if graphed:
                for name in ("train_step", "player_step"):
                    entry = plan.stats()["entries"][name]
                    assert entry["fallbacks"] == 0 and entry["aot_calls"] == 2 and entry["compiled"], entry
                    assert not any(entry["launches_per_replay"].values()), entry
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    assert torch.isfinite(results[False][0]).all() and len(results[False]) == len(results[True])
    assert [i for i, (a, b) in enumerate(zip(results[False], results[True])) if not torch.equal(a, b)] == []
