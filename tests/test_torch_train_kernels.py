"""The training slice's kernel modules and math against the reference's.

Each kernel's plain forward (with its residual outputs) is held against the
reference's Pallas kernel run in interpret mode (as
tests/test_ops/test_pallas.py runs it), and the port's autograd.Function
gradients against `jax.vjp` of the reference's `custom_vjp` function:
float32, atol/rtol 1e-5 (the same products summed in other orders). The
math, distributions, moments, clipping, the transposed conv, DeCNN and the
replay buffer's sampling windows are held against their JAX counterparts.
The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_cnn
from sheeprl_tpu.ops import pallas_kernels as pk
from sheeprl_tpu_torch.ops.kernels import cnn, deconv, gru, two_hot
from tests.test_torch_interop import jax_flat

ATOL = RTOL = 1e-5


@pytest.fixture
def pallas_interpret():
    pk.set_pallas(True, interpret=True)
    yield
    pk.set_pallas(None, interpret=False)


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=msg)


def _leaves(arrays, grad=True):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad) for a in arrays]


def _vjp(fn, arrays, cot):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    return vjp(jnp.asarray(cot))


# ---------------------------------------------------------------------------
# the GRU's residual forward and its backward
# ---------------------------------------------------------------------------


def _gru_inputs(rng, batch, dx, hidden):
    return (
        rng.normal(size=(batch, dx)).astype(np.float32),
        rng.normal(size=(batch, hidden)).astype(np.float32),
        (rng.normal(size=(dx + hidden, 3 * hidden)) * 0.2).astype(np.float32),  # reference [in, out]
        (rng.normal(size=(3 * hidden,)) + 1.0).astype(np.float32),
        (rng.normal(size=(3 * hidden,)) * 0.1).astype(np.float32),
    )


@pytest.mark.parametrize("batch,dx,hidden", [(4, 6, 8), (16, 16, 32), (3, 24, 16)])
def test_gru_residual_forward_matches_pallas_kernel(pallas_interpret, batch, dx, hidden):
    x, h, w, scale, offset = _gru_inputs(np.random.default_rng(batch + hidden), batch, dx, hidden)
    want = pk._gru_forward_with_residuals(*map(jnp.asarray, (x, h, w, scale, offset)), 1e-5)
    got = gru.layernorm_gru_cell_residuals(*_leaves((x, h, w.T, scale, offset), False), 1e-5)
    for g, wv, name in zip(got, want, ("out", "hat", "rstd")):
        _close(g, wv, msg=name)


@pytest.mark.parametrize("batch,dx,hidden", [(4, 6, 8), (5, 16, 32)])
def test_gru_gradients_match_custom_vjp(pallas_interpret, batch, dx, hidden):
    rng = np.random.default_rng(10 * batch + hidden)
    x, h, w, scale, offset = _gru_inputs(rng, batch, dx, hidden)
    cot = rng.normal(size=(batch, hidden)).astype(np.float32)
    want = _vjp(lambda *a: pk.layernorm_gru_cell(*a, 1e-5), (x, h, w, scale, offset), cot)
    leaves = _leaves((x, h, w.T, scale, offset))
    gru.layernorm_gru_cell(*leaves, 1e-5).backward(torch.from_numpy(cot))
    for leaf, wv, name in zip(leaves, want, ("x", "h", "w", "scale", "offset")):
        _close(leaf.grad, np.asarray(wv).T if name == "w" else wv, msg=name)


def test_gru_backward_skips_the_weight_when_it_needs_no_gradient():
    """Imagination differentiates through x only: the weight gets no
    gradient and x's is unchanged."""
    rng = np.random.default_rng(5)
    x, h, w, scale, offset = _gru_inputs(rng, 3, 6, 8)
    cot = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    full = _leaves((x, h, w.T, scale, offset))
    gru.layernorm_gru_cell(*full, 1e-5).backward(cot)
    xs = _leaves((x,))[0]
    rest = _leaves((h, w.T, scale, offset), False)
    gru.layernorm_gru_cell(xs, *rest, 1e-5).backward(cot)
    assert rest[1].grad is None
    torch.testing.assert_close(xs.grad, full[0].grad, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the conv's residual forward, the deconv, two_hot
# ---------------------------------------------------------------------------


def _stage_inputs(rng, n, size, cin, cout):
    return (
        rng.normal(size=(n, size, size, cin)).astype(np.float32),
        (rng.normal(size=(4, 4, cin, cout)) * 0.3).astype(np.float32),
        (rng.normal(size=(cout,)) + 1.0).astype(np.float32),
        (rng.normal(size=(cout,)) * 0.1).astype(np.float32),
    )


# the last cases (here and for the deconv) pass the 512 channels a warp's
# registers hold in the CUDA kernels' pixel pass
@pytest.mark.parametrize("n,size,cin,cout", [(2, 16, 3, 8), (1, 8, 8, 16), (3, 4, 16, 32), (2, 8, 16, 640)])
def test_conv_residual_forward_and_gradients_match(pallas_interpret, n, size, cin, cout):
    rng = np.random.default_rng(n * 100 + size + cout)
    x, w, scale, offset = _stage_inputs(rng, n, size, cin, cout)
    y_ref, pre_ref = pallas_cnn._enc_call(
        jnp.asarray(x), pallas_cnn._enc_w3(jnp.asarray(w)), jnp.asarray(scale), jnp.asarray(offset), 1e-3, True
    )
    y, pre = cnn.conv_ln_silu_residuals(*_leaves((x, w, scale, offset), False), 1e-3)
    _close(y, y_ref, msg="y")
    _close(pre, pre_ref, msg="pre")
    cot = rng.normal(size=y.shape).astype(np.float32)
    want = _vjp(lambda *a: pallas_cnn.conv_ln_silu(*a, 1e-3), (x, w, scale, offset), cot)
    leaves = _leaves((x, w, scale, offset))
    cnn.conv_ln_silu(*leaves, 1e-3).backward(torch.from_numpy(cot))
    for leaf, wv, name in zip(leaves, want, ("x", "w", "scale", "offset")):
        _close(leaf.grad, wv, msg=name)


@pytest.mark.parametrize("n,size,cin,cout", [(2, 4, 16, 8), (1, 8, 8, 4), (2, 2, 32, 16), (2, 4, 16, 640)])
def test_deconv_forward_and_gradients_match(pallas_interpret, n, size, cin, cout):
    rng = np.random.default_rng(n * 100 + size + cin)
    x, k, scale, offset = _stage_inputs(rng, n, size, cin, cout)
    args = tuple(map(jnp.asarray, (x, k, scale, offset)))
    y_ref = pallas_cnn.deconv_ln_silu(*args, 1e-3)
    _, pre_ref = pallas_cnn._dec_call(args[0], pallas_cnn._dec_w3(args[1]), args[2], args[3], 1e-3, True)
    y, pre = deconv.deconv_ln_silu_residuals(*_leaves((x, k, scale, offset), False), 1e-3)
    assert y.shape == (n, 2 * size, 2 * size, cout)
    _close(y, y_ref, msg="y")
    _close(pre, pre_ref, msg="pre")
    _close(deconv.deconv_ln_silu(*_leaves((x, k, scale, offset), False), 1e-3), y_ref, msg="plain forward")
    cot = rng.normal(size=y.shape).astype(np.float32)
    want = _vjp(lambda *a: pallas_cnn.deconv_ln_silu(*a, 1e-3), (x, k, scale, offset), cot)
    leaves = _leaves((x, k, scale, offset))
    deconv.deconv_ln_silu(*leaves, 1e-3).backward(torch.from_numpy(cot))
    for leaf, wv, name in zip(leaves, want, ("x", "k", "scale", "offset")):
        _close(leaf.grad, wv, msg=name)


def test_subpixel_deconv_is_the_references_transposed_conv():
    """The plain deconv follows the reference's phase regrouping, which is
    `lax.conv_transpose(..., 'SAME')`; torch's conv_transpose2d on the
    permuted kernel is another function."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 5, 3, 6)).astype(np.float32)
    k = rng.normal(size=(4, 4, 6, 7)).astype(np.float32)
    got = deconv.subpixel_deconv(torch.from_numpy(x), torch.from_numpy(k))
    _close(got, pallas_cnn._dec_deconv(jnp.asarray(x), jnp.asarray(k)))
    _close(got, jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC")), atol=1e-4)
    naive = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(k).permute(2, 3, 0, 1), stride=2, padding=1
    ).permute(0, 2, 3, 1)
    assert float((naive - got).abs().max()) > 1e-2


@pytest.mark.parametrize("kernel,stride,padding", [(4, 2, "SAME"), (3, 1, "SAME"), (4, 2, "VALID"),
                                                   (3, 2, "SAME"), (2, 2, 1)])
def test_conv_transpose_layer_matches_reference(kernel, stride, padding):
    from sheeprl_tpu.nn.layers import ConvTranspose2d as JaxConvT
    from sheeprl_tpu_torch.interop import load_jax_params
    from sheeprl_tpu_torch.nn.layers import ConvTranspose2d

    ref = JaxConvT.init(jax.random.PRNGKey(kernel + stride), 5, 6, kernel, stride=stride, padding=padding)
    port = load_jax_params(ConvTranspose2d(5, 6, kernel, stride=stride, padding=padding), jax_flat(ref))
    x = np.random.default_rng(2).normal(size=(2, 7, 6, 5)).astype(np.float32)
    _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)), atol=1e-5)


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
def test_decnn_matches_reference(interpret):
    """The DreamerV3 decoder trunk (3 fused stages + the plain biased last
    stage) against the reference's DeCNN, its Pallas stages on or off."""
    from sheeprl_tpu.nn.blocks import DeCNN as JaxDeCNN
    from sheeprl_tpu_torch.interop import load_jax_params
    from sheeprl_tpu_torch.nn.blocks import DeCNN

    kw = dict(kernel_sizes=[4] * 4, strides=[2] * 4, act="silu", layer_norm=True, use_bias=False, norm_eps=1e-3)
    ref = JaxDeCNN.init(jax.random.PRNGKey(3), 16, [8, 4, 2, 3], **kw)
    port = load_jax_params(DeCNN(16, [8, 4, 2, 3], **kw), jax_flat(ref))
    x = np.random.default_rng(4).normal(size=(2, 3, 4, 4, 16)).astype(np.float32)
    pk.set_pallas(interpret or None, interpret=interpret)
    try:
        want = ref(jnp.asarray(x))
    finally:
        pk.set_pallas(None, interpret=False)
    got = port(torch.from_numpy(x))
    assert got.shape == (2, 3, 64, 64, 3)
    _close(got, want, atol=1e-4)


def _two_hot_inputs(rng, n, k):
    bins = np.linspace(-3.0, 3.0, k).astype(np.float32)[None]
    x = (rng.normal(size=(n, 1)) * 2.5).astype(np.float32)
    x[0], x[1], x[2] = -7.0, 9.0, bins[0, k // 2]  # beyond both edges, on a bin
    x[3] = bins[0, 0]
    return x, (rng.normal(size=(n, k)) * 2).astype(np.float32), bins


# K = 1, and K past the 1,024 bins the first CUDA kernel refused (1,025,
# 2,048): the reference sets no limit on the bins
@pytest.mark.parametrize("n,k", [(8, 15), (33, 255), (7, 1), (9, 1025), (5, 2048)])
def test_two_hot_forward_and_gradients_match(pallas_interpret, n, k):
    rng = np.random.default_rng(n + k)
    x, logits, bins = _two_hot_inputs(rng, n, k)
    want = pk._two_hot_forward(*map(jnp.asarray, (x, logits, bins)))
    _close(two_hot.two_hot_log_prob(*_leaves((x, logits, bins), False)), want)
    cot = rng.normal(size=(n, 1)).astype(np.float32)
    want_g = _vjp(pk.two_hot_log_prob, (x, logits, bins), cot)
    leaves = _leaves((x, logits, bins))
    two_hot.two_hot_log_prob(*leaves).backward(torch.from_numpy(cot))
    for leaf, wv, name in zip(leaves, want_g, ("x", "logits", "bins")):
        _close(leaf.grad, wv, msg=name)


def test_dense_two_hot_matches_reference():
    from sheeprl_tpu.ops.math import two_hot as jax_two_hot

    x, _, bins = _two_hot_inputs(np.random.default_rng(1), 12, 9)
    got = two_hot.two_hot(torch.from_numpy(x[:, 0]), torch.from_numpy(bins[0]))
    _close(got, jax_two_hot(jnp.asarray(x[:, 0]), jnp.asarray(bins[0])))
    torch.testing.assert_close(got.sum(-1), torch.ones(12))


def test_cpu_wrappers_count_no_launch():
    counters = (gru.layernorm_gru_cell_residuals, cnn.conv_ln_silu_residuals, deconv.deconv_ln_silu,
                two_hot.two_hot_log_prob)
    before = [c.launches for c in counters]
    rng = np.random.default_rng(0)
    gru.layernorm_gru_cell(*_leaves((lambda a: (a[0], a[1], a[2].T, a[3], a[4]))(_gru_inputs(rng, 2, 4, 8))))
    cnn.conv_ln_silu(*_leaves(_stage_inputs(rng, 1, 8, 3, 8)))
    deconv.deconv_ln_silu(*_leaves(_stage_inputs(rng, 1, 4, 8, 4)))
    two_hot.two_hot_log_prob(*_leaves(_two_hot_inputs(rng, 6, 9)))
    assert [c.launches for c in counters] == before


def test_wrappers_reject_what_the_new_kernels_do_not_take():
    rng = np.random.default_rng(6)
    x, k, scale, offset = map(torch.from_numpy, _stage_inputs(rng, 1, 4, 8, 4))
    with pytest.raises(ValueError, match="k must be"):
        deconv.deconv_ln_silu(x, k[:3], scale, offset)
    with pytest.raises(TypeError):
        deconv.deconv_ln_silu(x.double(), k.double(), scale, offset)
    tx, logits, bins = map(torch.from_numpy, _two_hot_inputs(rng, 6, 9))
    with pytest.raises(ValueError, match="bins must be"):
        two_hot.two_hot_log_prob(tx, logits, bins[:, :5])
    with pytest.raises(TypeError):
        two_hot.two_hot_log_prob(tx.double(), logits, bins)


@pytest.mark.parametrize("shape,stride,padding,act", [
    ((4, 4, 3, 32), (2, 2), "SAME", "silu"),
    ((4, 4, 256, 1024), (2, 2), "SAME", "silu"),  # above the CUDA kernel's Cout: still the kernel's stage
    ((3, 3, 3, 8), (2, 2), "SAME", "silu"),
    ((4, 4, 3, 8), (1, 1), "SAME", "silu"),
    ((4, 4, 3, 8), (2, 2), "VALID", "silu"),
    ((4, 4, 3, 8), (2, 2), "SAME", "relu"),
])
def test_stage_guard_is_the_references(shape, stride, padding, act):
    pk.set_pallas(True)
    try:
        want = pallas_cnn.cnn_stage_supported(shape, stride, padding, True, act)
    finally:
        pk.set_pallas(None)
    assert cnn.cnn_stage_supported(shape, stride, padding, True, act) == want


# ---------------------------------------------------------------------------
# math, distributions, moments, clipping, buffer
# ---------------------------------------------------------------------------


def test_lambda_values_symexp_and_decay_match():
    from sheeprl_tpu.ops import math as jm
    from sheeprl_tpu_torch.ops import math as tm

    rng = np.random.default_rng(3)
    r, v = rng.normal(size=(6, 5, 1)).astype(np.float32), rng.normal(size=(6, 5, 1)).astype(np.float32)
    c = (rng.random(size=(6, 5, 1)) > 0.2).astype(np.float32) * 0.99
    _close(tm.lambda_values_dv3(*map(torch.from_numpy, (r, v, c)), lmbda=0.9),
           jm.lambda_values_dv3(*map(jnp.asarray, (r, v, c)), lmbda=0.9))
    _close(tm.symexp(torch.from_numpy(r)), jm.symexp(jnp.asarray(r)))
    for step in (0, 3, 50, 200):
        assert tm.polynomial_decay(step, initial=1.0, final=0.1, max_decay_steps=100) == pytest.approx(
            jm.polynomial_decay(step, initial=1.0, final=0.1, max_decay_steps=100))


def test_moments_match_and_interpolate_linearly():
    from sheeprl_tpu.ops import Moments as JaxMoments
    from sheeprl_tpu_torch.ops.moments import Moments

    rng = np.random.default_rng(4)
    ref, port = JaxMoments.init(0.9, 1.0, 0.05, 0.95), Moments(0.9, 1.0, 0.05, 0.95)
    for _ in range(3):
        x = rng.normal(size=(7, 11, 1)).astype(np.float32) * 3
        ref, (r_off, r_inv) = ref.update(jnp.asarray(x))
        off, inv = port.update(torch.from_numpy(x))
        _close(off, r_off)
        _close(inv, r_inv)
    # both default to linear interpolation between the two nearest ranks
    x = np.arange(5, dtype=np.float32)
    assert float(torch.quantile(torch.from_numpy(x), 0.3)) == pytest.approx(1.2)
    assert float(jnp.quantile(jnp.asarray(x), 0.3)) == pytest.approx(1.2)


def test_distributions_match():
    from sheeprl_tpu.ops import distributions as jd
    from sheeprl_tpu_torch.ops import distributions as td

    rng = np.random.default_rng(8)
    logits = rng.normal(size=(3, 4, 9)).astype(np.float32)
    q = rng.normal(size=(3, 4, 9)).astype(np.float32)
    _close(td.kl_categorical(*map(torch.from_numpy, (logits, q))), jd.kl_categorical(*map(jnp.asarray, (logits, q))))
    onehot = np.eye(9, dtype=np.float32)[rng.integers(0, 9, (3, 4))]
    ref, port = jd.OneHotCategorical.from_logits(jnp.asarray(logits)), td.OneHotCategorical(torch.from_numpy(logits))
    _close(port.log_prob(torch.from_numpy(onehot)), ref.log_prob(jnp.asarray(onehot)))
    _close(port.entropy(), ref.entropy())
    b = rng.normal(size=(3, 4, 1)).astype(np.float32)
    tgt = (rng.random(size=(3, 4, 1)) > 0.5).astype(np.float32)
    ref_b = jd.Independent(base=jd.Bernoulli(logits=jnp.asarray(b)), event_ndims=1)
    port_b = td.Independent(td.Bernoulli(torch.from_numpy(b)), 1)
    _close(port_b.log_prob(torch.from_numpy(tgt)), ref_b.log_prob(jnp.asarray(tgt)))
    _close(port_b.mode, ref_b.mode)
    mode, obs = rng.normal(size=(3, 4, 5)).astype(np.float32), rng.normal(size=(3, 4, 5)).astype(np.float32) * 4
    _close(td.SymlogDistribution(torch.from_numpy(mode)).log_prob(torch.from_numpy(obs)),
           jd.SymlogDistribution(_mode=jnp.asarray(mode)).log_prob(jnp.asarray(obs)))
    _close(td.MSEDistribution(torch.from_numpy(mode), dims=2).log_prob(torch.from_numpy(obs)),
           jd.MSEDistribution(_mode=jnp.asarray(mode), dims=2).log_prob(jnp.asarray(obs)), rtol=1e-5, atol=1e-4)
    th_logits = rng.normal(size=(3, 4, 255)).astype(np.float32)
    vals = (rng.normal(size=(3, 4, 1)) * 30).astype(np.float32)
    ref_t = jd.TwoHotEncodingDistribution(logits=jnp.asarray(th_logits), dims=1)
    port_t = td.TwoHotEncodingDistribution(torch.from_numpy(th_logits), dims=1)
    _close(port_t.log_prob(torch.from_numpy(vals)), ref_t.log_prob(jnp.asarray(vals)), atol=1e-4)
    _close(port_t.mean, ref_t.mean, atol=1e-4, rtol=1e-4)


def test_clip_by_global_norm_is_optax():
    import optax

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import clip_by_global_norm

    rng = np.random.default_rng(2)
    grads = [rng.normal(size=s).astype(np.float32) * 3 for s in ((4, 5), (7,), (2, 3, 2))]
    norm = float(optax.global_norm([jnp.asarray(g) for g in grads]))
    for max_norm in (norm / 3, norm * 2):
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        got, got_norm = clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
        assert float(got_norm) == pytest.approx(norm, rel=1e-6)
        for g, w in zip(got, want):
            _close(g, w, atol=1e-6, rtol=1e-6)


def test_buffer_windows_and_sampling_match_reference():
    """Per-env write heads and validity windows after the same adds
    (partial-env adds and ring wrap included) equal the reference's
    AsyncReplayBuffer; sampled windows are contiguous ring rows of one env,
    and injected (env, start) pairs replay exactly."""
    from sheeprl_tpu.data.buffers import AsyncReplayBuffer as JaxBuffer
    from sheeprl_tpu_torch.data.buffers import AsyncReplayBuffer

    ref, port = JaxBuffer(6, 2, sequential=True, obs_keys=("o",)), AsyncReplayBuffer(6, 2, seed=0)
    step = 0
    for indices in (None, None, [1], None, [0], None, None, [1], None):
        width = 2 if indices is None else len(indices)
        data = {"o": np.full((1, width, 1), step, np.float32), "t": np.full((1, width, 1), step, np.float32)}
        ref.add(data, indices)
        port.add(data, indices)
        step += 1
        np.testing.assert_array_equal(port._pos, ref._upos)
        np.testing.assert_array_equal(port._full, ref._ufull)
        for exclude in (0, 2):
            for a, b in zip(port._windows(exclude), ref._windows(exclude)):
                np.testing.assert_array_equal(a, b)
    out = port.sample(4, sequence_length=3, n_samples=2)
    assert out["o"].shape == (2, 3, 4, 1)
    steps = out["o"][..., 0]
    assert np.all(np.diff(steps, axis=1) > 0)  # each window is consecutive rows of one ring
    env, start = np.array([0, 1, 1, 0]), np.array([0, 2, 5, 3])
    again = port.sample(2, sequence_length=2, n_samples=2, indices=(env, start))
    for i, (e, s) in enumerate(zip(env, start)):
        rows = (s + np.arange(2)) % 6
        np.testing.assert_array_equal(again["o"][i // 2, :, i % 2], port._buf["o"][rows, e])


@pytest.mark.parametrize("block", ["cnn", "decnn", "gru"])
def test_module_gradients_match_custom_vjp(pallas_interpret, block):
    """Through the modules: x.grad and every parameter's grad (weights, LN
    scales and offsets) under CNN, DeCNN and LayerNormGRUCell equal the
    reference's gradients through its Pallas custom_vjp kernels. atol/rtol
    1e-4: a gradient here is summed through up to three stages."""
    from sheeprl_tpu import nn as jnn
    from sheeprl_tpu_torch import nn as tnn
    from sheeprl_tpu_torch.interop import load_jax_params, state_dict_from_jax

    kw = dict(act="silu", layer_norm=True, use_bias=False, norm_eps=1e-3)
    rng = np.random.default_rng(11)
    if block == "cnn":
        ref = jnn.CNN.init(jax.random.PRNGKey(1), 3, [4, 8], [4, 4], [2, 2], **kw)
        port = tnn.CNN(3, [4, 8], [4, 4], [2, 2], **kw)
        inputs = [rng.normal(size=(2, 16, 16, 3)).astype(np.float32)]
    elif block == "decnn":
        ref = jnn.DeCNN.init(jax.random.PRNGKey(2), 8, [6, 4, 3], [4] * 3, [2] * 3, **kw)
        port = tnn.DeCNN(8, [6, 4, 3], [4] * 3, [2] * 3, **kw)
        inputs = [rng.normal(size=(2, 4, 4, 8)).astype(np.float32)]
    else:
        ref = jnn.LayerNormGRUCell.init(jax.random.PRNGKey(3), 6, 8)
        port = tnn.LayerNormGRUCell(6, 8)
        inputs = [rng.normal(size=(3, 6)).astype(np.float32), rng.normal(size=(3, 8)).astype(np.float32)]
    # random LayerNorm affines, so their gradients are not trivially shaped
    leaves, treedef = jax.tree_util.tree_flatten(ref)
    keys = jax.random.split(jax.random.PRNGKey(4), len(leaves))
    ref = jax.tree_util.tree_unflatten(
        treedef, [leaf + 0.3 * jax.random.normal(k, leaf.shape) for k, leaf in zip(keys, leaves)]
    )
    load_jax_params(port, jax_flat(ref))
    out_shape = jax.eval_shape(lambda m, *a: m(*a), ref, *map(jnp.asarray, inputs)).shape
    cot = rng.normal(size=out_shape).astype(np.float32)

    def loss(m, *a):
        return jnp.sum(m(*a) * cot)

    grads = jax.grad(loss, argnums=tuple(range(len(inputs) + 1)))(ref, *map(jnp.asarray, inputs))
    leaves = _leaves(inputs)
    (port(*leaves) * torch.from_numpy(cot)).sum().backward()
    for leaf, want in zip(leaves, grads[1:]):
        _close(leaf.grad, want, atol=1e-4, rtol=1e-4, msg="input")
    want = state_dict_from_jax(port, jax_flat(grads[0]))
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        _close(p.grad, want[name], atol=1e-4, rtol=1e-4, msg=name)
