"""The port's int8 quantization (`ops/quant.py`), the fused SAC trunk's
plain version (`ops/kernels/int8_trunk.py`) and symlog/symexp
(`ops/kernels/symlog.py`) against the JAX package, on the CPU, at small
widths (hidden 32), inputs from a numpy seed, weights carried by
`interop.py`. The reference's Pallas kernels run in interpret mode, as its
own tests run them.

Tolerances: quantization, `QuantLinear.from_linear` and the first layer's
calibration scales are exact (the same IEEE f32 operations on the same
inputs); deeper calibration scales rtol 1e-6 (they follow an f32 forward
whose sums run in another order), plus 1e-6 of the layer's largest scale
for a channel whose small absmax is a cancelled sum; the trunk and
symlog/symexp atol 1e-6 (the reference notes its own interpreter and XLA may fuse the dequant's
multiply-add into an FMA, an f32 ulp apart; symexp adds rtol 1e-6 for its
values above 1)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_kernels as pk
from sheeprl_tpu.ops import quant as jq
from sheeprl_tpu_torch.ops import quant as tq
from sheeprl_tpu_torch.ops.kernels import int8_trunk, symlog
from tests.test_torch_interop import jax_flat

OBS_DIM, ACT_DIM, HIDDEN = 3, 1, 32


@pytest.fixture
def pallas_interpret():
    pk.set_pallas(True, interpret=True)
    yield
    pk.set_pallas(None, interpret=False)


def sac_actors(seed: int = 0, hidden: int = HIDDEN, obs_dim: int = OBS_DIM, act_dim: int = ACT_DIM):
    """(jax_actor, torch_actor): the same SAC actor on both sides, the
    port's weights carried across from the reference's."""
    from sheeprl_tpu.algos.sac.agent import SACActor as JaxActor
    from sheeprl_tpu_torch.algos.sac.agent import SACActor
    from sheeprl_tpu_torch.interop import load_jax_params

    jactor = JaxActor.init(jax.random.PRNGKey(seed), obs_dim, act_dim, hidden_size=hidden,
                           action_low=np.full(act_dim, -2.0, np.float32),
                           action_high=np.full(act_dim, 2.0, np.float32))
    tactor = SACActor(obs_dim, act_dim, hidden_size=hidden, action_low=-2.0, action_high=2.0)
    load_jax_params(tactor, jax_flat(jactor))
    return jactor, tactor


def calib_batches(seed: int = 3, rows: int = 64, n: int = 4, obs_dim: int = OBS_DIM):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, obs_dim)).astype(np.float32) for _ in range(n)]


def quantized_actors(seed: int = 0):
    """(jax_qactor, torch_qactor, jax scales): the reference calibrates and
    quantizes; the port gets the reference's quantized weights through
    `interop.py` (w_q transposed, the int8 kept)."""
    from sheeprl_tpu_torch.interop import load_jax_params

    jactor, tactor = sac_actors(seed)
    scales = jq.calibrate(jactor, lambda m, obs: m.get_greedy_actions(jnp.asarray(obs)), calib_batches())
    jq_actor = jq.quantize_linears(jactor, scales)
    tq_actor = tq.quantize_linears(tactor, scales)
    load_jax_params(tq_actor, jax_flat(jq_actor))
    return jq_actor, tq_actor, scales


# ---------------------------------------------------------------------------
# quantize / QuantLinear
# ---------------------------------------------------------------------------


def test_quantize_rounds_half_to_even_and_clips():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.5, 300.0, -127.5, -300.0, 0.49999997],
                 np.float32)
    want = np.array([0, 2, 2, 0, -2, -2, 126, 127, 127, -127, -127, 0], np.int8)
    got = tq.quantize(torch.from_numpy(x), torch.tensor(1.0)).numpy()
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(jq.quantize(jnp.asarray(x), jnp.float32(1.0))), want)
    # random values and per-channel scales: equal to the reference's, element for element
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((64, 48)) * 5).astype(np.float32)
    s = (np.abs(rng.standard_normal(48)) * 0.05 + 1e-3).astype(np.float32)
    np.testing.assert_array_equal(tq.quantize(torch.from_numpy(v), torch.from_numpy(s)).numpy(),
                                  np.asarray(jq.quantize(jnp.asarray(v), jnp.asarray(s))))


def test_absmax_scale_floors_dead_channels():
    w = np.zeros((4, 3), np.float32)
    w[:, 1] = [0.0, -254.0, 1.0, 2.0]
    got = tq.absmax_scale(torch.from_numpy(w), dim=0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.absmax_scale(jnp.asarray(w), axis=0)))
    np.testing.assert_array_equal(got, np.array([1e-8, 2.0, 1e-8], np.float32))


def test_quant_linear_from_linear_is_bit_equal():
    from sheeprl_tpu.nn.layers import Linear as JaxLinear
    from sheeprl_tpu_torch.nn.layers import Linear

    jlin = JaxLinear.init(jax.random.PRNGKey(1), 24, 40)
    tlin = Linear(24, 40)
    with torch.no_grad():
        tlin.weight.copy_(torch.from_numpy(np.array(jlin.weight).T))
        tlin.bias.copy_(torch.from_numpy(np.array(jlin.bias)))
    in_scale = (np.abs(np.random.default_rng(2).standard_normal(24)) * 0.1 + 1e-3).astype(np.float32)
    jql = jq.QuantLinear.from_linear(jlin, jnp.asarray(in_scale))
    tql = tq.QuantLinear.from_linear(tlin, in_scale)
    assert tql.w_q.dtype == torch.int8 and tuple(tql.w_q.shape) == (40, 24)
    assert (tql.in_features, tql.out_features) == (24, 40)
    np.testing.assert_array_equal(tql.w_q.numpy(), np.asarray(jql.w_q).T)
    np.testing.assert_array_equal(tql.w_scale.numpy(), np.asarray(jql.w_scale))
    np.testing.assert_array_equal(tql.in_scale.numpy(), np.asarray(jql.in_scale))
    np.testing.assert_array_equal(tql.bias.numpy(), np.asarray(jql.bias))
    x = np.random.default_rng(3).standard_normal((5, 24)).astype(np.float32)
    np.testing.assert_allclose(tql(torch.from_numpy(x)).numpy(), np.asarray(jql(jnp.asarray(x))), atol=1e-6)


def test_int8_linear_accumulates_exactly_and_wraps_like_int32():
    # 127 * 127 * 140,000 = 2.26e9 overflows int32: the reference's
    # accumulator wraps, and so does the plain version
    k = 140_000
    x = torch.full((1, k), 127.0)
    w = torch.full((1, k), 127, dtype=torch.int8)
    ones = torch.ones(1)
    got = tq.int8_linear(x, torch.ones(k), w, ones, None)
    wrapped = np.array([127 * 127 * k], np.int64).astype(np.int32).astype(np.float32)
    np.testing.assert_array_equal(got.numpy()[0], wrapped)


# ---------------------------------------------------------------------------
# the trunk's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


def _trunk_layers(rng, dims):
    """Per layer (in_scale, w_q [in, out], w_scale, bias) as the reference
    builds them, as numpy."""
    layers = []
    for n_in, n_out in zip(dims[:-1], dims[1:]):
        w = rng.standard_normal((n_in, n_out)).astype(np.float32) * 0.3
        s_in = jnp.asarray(np.abs(rng.standard_normal(n_in)) + 0.05, jnp.float32)
        w_eff = jnp.asarray(w) * s_in[:, None]
        ws = jq.absmax_scale(w_eff, axis=0)
        layers.append(tuple(np.array(a) for a in (
            s_in, jq.quantize(w_eff, ws), ws, jnp.asarray(rng.standard_normal(n_out), jnp.float32))))
    return layers


@pytest.mark.parametrize("batch", [1, 5, 64])
@pytest.mark.parametrize("dims", [(OBS_DIM, HIDDEN, HIDDEN, ACT_DIM), (17, 40, 24, 6)], ids=["pendulum", "wide"])
def test_int8_trunk_reference_matches_pallas_kernel(pallas_interpret, batch, dims):
    rng = np.random.default_rng(batch + dims[0])
    layers = _trunk_layers(rng, dims)
    x = (rng.standard_normal((batch, dims[0])) * 2).astype(np.float32)
    want = np.asarray(pk.fused_int8_trunk(jnp.asarray(x), *(jnp.asarray(a) for layer in layers for a in layer)))
    targs = [torch.from_numpy(np.ascontiguousarray(a.T) if a.dtype == np.int8 else a)
             for layer in layers for a in layer]
    got = int8_trunk.int8_trunk_reference(torch.from_numpy(x), *targs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # the wrapper takes the plain version on CPU tensors, and counts nothing
    before = int8_trunk.fused_int8_trunk.launches
    np.testing.assert_array_equal(int8_trunk.fused_int8_trunk(torch.from_numpy(x), *targs).numpy(), got.numpy())
    assert int8_trunk.fused_int8_trunk.launches == before


def test_fused_int8_trunk_checks_its_inputs():
    rng = np.random.default_rng(0)
    layers = _trunk_layers(rng, (OBS_DIM, 8, 8, ACT_DIM))
    targs = [torch.from_numpy(np.ascontiguousarray(a.T) if a.dtype == np.int8 else a)
             for layer in layers for a in layer]
    x = torch.zeros(2, OBS_DIM)
    with pytest.raises(ValueError, match="w_q"):
        int8_trunk.fused_int8_trunk(x, *targs[:1], targs[1].T.contiguous(), *targs[2:])
    with pytest.raises(ValueError, match="x must be"):
        int8_trunk.fused_int8_trunk(x.double(), *targs)
    with pytest.raises(ValueError, match="contiguous"):
        int8_trunk.fused_int8_trunk(torch.zeros(OBS_DIM, 2).t(), *targs)


@pytest.mark.parametrize("over", [0, 1], ids=["at_edge", "one_byte_over"])
def test_guard_decides_as_the_reference_at_its_edge(over):
    budget = 10 * 1024 * 1024
    small = [np.zeros(n, dt) for n, dt in ((256, np.float32), (256, np.float32), (1000, np.int8))]
    rest = budget - sum(a.nbytes for a in small) + over
    arrays = [*small, np.zeros(rest, np.int8)]
    want = pk.fused_int8_trunk_supported(*(jnp.asarray(a) for a in arrays))
    got = int8_trunk.fused_int8_trunk_supported(*(torch.from_numpy(a) for a in arrays))
    assert got == want == (over == 0)


# ---------------------------------------------------------------------------
# calibration and the module traversal
# ---------------------------------------------------------------------------


def test_calibrate_matches_the_reference():
    jactor, tactor = sac_actors()
    batches = calib_batches()
    want = jq.calibrate(jactor, lambda m, obs: m.get_greedy_actions(jnp.asarray(obs)), batches)
    got = tq.calibrate(tactor, lambda m, obs: m.get_greedy_actions(obs),
                       [torch.from_numpy(b) for b in batches])
    assert sorted(got) == sorted(want) == sorted(tq.linear_paths(tactor)) == sorted(jq.linear_paths(jactor))
    assert sorted(got) == ["fc_logstd", "fc_mean", "model.layers.0", "model.layers.1"]
    np.testing.assert_array_equal(got["model.layers.0"], want["model.layers.0"])
    for path in ("model.layers.1", "fc_mean", "fc_logstd"):
        # a channel's absmax is a sum of f32 products in another order: its
        # error scales with the summands, not with a small (cancelled) result
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6, atol=1e-6 * want[path].max(),
                                   err_msg=path)
    assert all(v.dtype == np.float32 for v in got.values())


def test_quantize_linears_copies_and_leaves_the_original():
    jactor, tactor = sac_actors()
    scales = jq.calibrate(jactor, lambda m, obs: m.get_greedy_actions(jnp.asarray(obs)), calib_batches())
    qactor = tq.quantize_linears(tactor, {k: v for k, v in scales.items() if k != "fc_logstd"})
    assert type(qactor) is type(tactor) and qactor is not tactor
    assert isinstance(qactor.model.layers[0], tq.QuantLinear) and isinstance(qactor.fc_mean, tq.QuantLinear)
    # an uncalibrated Linear stays f32; the original keeps its Linears
    assert qactor.fc_logstd is tactor.fc_logstd
    assert not any(isinstance(m, tq.QuantLinear) for m in tactor.modules())
    assert qactor.action_scale is tactor.action_scale
    assert tq.quantize_linears(tactor, {}) is tactor


def test_scales_written_by_either_package_load_in_the_other(tmp_path):
    jactor, tactor = sac_actors()
    scales = jq.calibrate(jactor, lambda m, obs: m.get_greedy_actions(jnp.asarray(obs)), calib_batches())
    path = jq.scales_path(str(tmp_path / "ckpt_100"))
    assert tq.scales_path(str(tmp_path / "ckpt_100/")) == path
    jq.save_scales(path, scales)
    loaded = tq.load_scales(path)
    assert sorted(loaded) == sorted(scales)
    qactor = tq.quantize_linears(tactor, loaded)
    assert all(isinstance(getattr(qactor, p), tq.QuantLinear) for p in ("fc_mean", "fc_logstd"))
    other = str(tmp_path / "port" / "quant_scales.npz")
    tq.save_scales(other, loaded)
    back = jq.load_scales(other)
    for k in scales:
        np.testing.assert_array_equal(back[k], scales[k])
    assert tq.load_scales(str(tmp_path / "missing.npz")) is None


def test_quantized_actor_matches_the_reference_quantized_actor():
    jq_actor, tq_actor, _ = quantized_actors()
    obs = np.random.default_rng(9).standard_normal((6, OBS_DIM)).astype(np.float32)
    want = np.asarray(jq_actor.get_greedy_actions(jnp.asarray(obs)))
    with torch.inference_mode():
        got = tq_actor.get_greedy_actions(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# symlog / symexp (kernel 8) against the reference's custom-VJP kernels
# ---------------------------------------------------------------------------


def _symlog_inputs(scale: float) -> np.ndarray:
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((16, 33)) * scale).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1e-7, -1e-7]
    return x


@pytest.mark.parametrize("name,scale", [("symlog", 30.0), ("symexp", 2.0)])
def test_symlog_symexp_and_gradients_match_the_reference(pallas_interpret, name, scale):
    x = _symlog_inputs(scale)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    jfn = getattr(pk, name)
    want, vjp = jax.vjp(jfn, jnp.asarray(x))
    (want_grad,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = getattr(symlog, name)(xt)
    (got_grad,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    # the analytic gradient at 0 is g (autograd through sign * f(|x|) would give 0)
    np.testing.assert_allclose(got_grad.numpy()[0, :2], g[0, :2], rtol=1e-6)
    plain = getattr(symlog, f"{name}_plain")(torch.from_numpy(x))
    np.testing.assert_array_equal(plain.numpy(), got.detach().numpy())


@pytest.mark.parametrize("name", ["symlog", "symexp"])
def test_symlog_bf16_rounds_once_and_matches_torch_sign(name):
    x = torch.tensor([0.0, -0.0, float("nan"), 3.0, -3.0, 1e-3, -40.0], dtype=torch.float32)
    fn = getattr(symlog, name)
    f32 = fn(x)
    assert torch.isnan(f32[2]) and f32[0] == 0 and not torch.signbit(f32[1])
    xb = x.to(torch.bfloat16)
    got = fn(xb)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, fn(xb.float()).to(torch.bfloat16), equal_nan=True, rtol=0, atol=0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(x.double())
