"""The port's two kernel modules against the reference's TPU kernels.

On the CPU each wrapper runs its plain PyTorch version; it is held against
the reference's Pallas kernel run in interpret mode (as
tests/test_ops/test_pallas.py runs it) and against the reference's plain
twin. Tolerance in float32: atol 1e-5, rtol 1e-5 (both sides sum the same
products in different orders). The CUDA kernels themselves run only on the
card: tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_cnn
from sheeprl_tpu.ops import pallas_kernels as pk
from sheeprl_tpu_torch.ops.kernels import cnn, gru

ATOL = RTOL = 1e-5


@pytest.fixture
def pallas_interpret():
    pk.set_pallas(True, interpret=True)
    yield
    pk.set_pallas(None, interpret=False)


def _gru_inputs(rng, batch, dx, hidden):
    x = rng.normal(size=(batch, dx)).astype(np.float32)
    h = rng.normal(size=(batch, hidden)).astype(np.float32)
    w = (rng.normal(size=(dx + hidden, 3 * hidden)) * 0.2).astype(np.float32)  # reference [in, out]
    scale = (rng.normal(size=(3 * hidden,)) + 1.0).astype(np.float32)
    offset = (rng.normal(size=(3 * hidden,)) * 0.1).astype(np.float32)
    return x, h, w, scale, offset


def _port_gru(x, h, w, scale, offset, eps):
    t = [torch.from_numpy(a) for a in (x, h, w.T.copy(), scale, offset)]  # port weight is [out, in]
    return gru.layernorm_gru_cell(*t, eps).numpy()


@pytest.mark.parametrize("batch,dx,hidden", [(4, 6, 8), (3, 16, 32), (1, 24, 16)])
def test_gru_plain_matches_pallas_kernel(pallas_interpret, batch, dx, hidden):
    rng = np.random.default_rng(batch * 100 + hidden)
    args = _gru_inputs(rng, batch, dx, hidden)
    want = np.asarray(pk.layernorm_gru_cell(*map(jnp.asarray, args), 1e-5))
    np.testing.assert_allclose(_port_gru(*args, 1e-5), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_gru_plain_matches_reference_twin(eps):
    args = _gru_inputs(np.random.default_rng(7), 5, 12, 8)
    want = np.asarray(pk._gru_reference(*map(jnp.asarray, args), eps))
    np.testing.assert_allclose(_port_gru(*args, eps), want, atol=ATOL, rtol=RTOL)


def _conv_inputs(rng, n, size, cin, cout):
    x = rng.normal(size=(n, size, size, cin)).astype(np.float32)
    w = (rng.normal(size=(4, 4, cin, cout)) * 0.3).astype(np.float32)
    scale = (rng.normal(size=(cout,)) + 1.0).astype(np.float32)
    offset = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, w, scale, offset


@pytest.mark.parametrize("n,size,cin,cout", [(2, 16, 3, 8), (1, 8, 8, 16), (3, 4, 16, 32)])
def test_conv_plain_matches_pallas_kernel(pallas_interpret, n, size, cin, cout):
    rng = np.random.default_rng(n * 1000 + size + cout)
    args = _conv_inputs(rng, n, size, cin, cout)
    want = np.asarray(pallas_cnn.conv_ln_silu(*map(jnp.asarray, args), 1e-3))
    got = cnn.conv_ln_silu(*map(torch.from_numpy, args), 1e-3).numpy()
    assert got.shape == (n, size // 2, size // 2, cout)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(3)
    g0, c0 = gru.layernorm_gru_cell.launches, cnn.conv_ln_silu.launches
    x, h, w, scale, offset = map(torch.from_numpy, _gru_inputs(rng, 2, 4, 8))
    w = w.t().contiguous()
    got = gru.layernorm_gru_cell(x, h, w, scale, offset, 1e-5)
    torch.testing.assert_close(got, gru.layernorm_gru_cell_plain(x, h, w, scale, offset, 1e-5), rtol=0, atol=0)
    cx, cw, cs, co = map(torch.from_numpy, _conv_inputs(rng, 1, 8, 3, 8))
    got = cnn.conv_ln_silu(cx, cw, cs, co, 1e-3)
    torch.testing.assert_close(got, cnn.conv_ln_silu_plain(cx, cw, cs, co, 1e-3), rtol=0, atol=0)
    assert (gru.layernorm_gru_cell.launches, cnn.conv_ln_silu.launches) == (g0, c0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(4)
    x, h, w, scale, offset = map(torch.from_numpy, _gru_inputs(rng, 2, 4, 8))
    with pytest.raises(ValueError, match="w must be"):
        gru.layernorm_gru_cell(x, h, w, scale, offset)  # reference layout, not the port's
    with pytest.raises(TypeError):
        gru.layernorm_gru_cell(x.double(), h.double(), w.t().contiguous().double(), scale, offset)
    with pytest.raises(ValueError, match="contiguous"):
        gru.layernorm_gru_cell(x, h, w.t(), scale, offset)
    cx, cw, cs, co = map(torch.from_numpy, _conv_inputs(rng, 1, 8, 3, 8))
    with pytest.raises(ValueError, match="even"):
        cnn.conv_ln_silu(cx[:, :7], cw, cs, co)
    with pytest.raises(ValueError, match="Cout"):
        cnn.conv_ln_silu(cx, torch.zeros(4, 4, 3, cnn.MAX_COUT + 1), torch.ones(cnn.MAX_COUT + 1),
                         torch.zeros(cnn.MAX_COUT + 1))
    assert not cnn.cnn_stage_supported((4, 4, 3, cnn.MAX_COUT + 1), (2, 2), "SAME", True, "silu")
    assert not cnn.cnn_stage_supported((3, 3, 3, 8), (2, 2), "SAME", True, "silu")
    assert cnn.cnn_stage_supported((4, 4, 3, 8), (2, 2), "SAME", True, "silu")
