"""The port's `nn` modules against the reference's, weights carried across by
`interop`: Linear, LayerNorm, Conv2d (its SAME-pad arithmetic), MLP, CNN and
LayerNormGRUCell. Each LayerNorm keeps its own eps (1e-3 in the Dreamer
MLPs and CNNs, 1e-5 in the GRU). Tolerance in float32: atol 1e-5, rtol 1e-5.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu import nn as jnn
from sheeprl_tpu_torch import nn as tnn
from sheeprl_tpu_torch.interop import load_jax_params
from tests.test_torch_interop import jax_flat

ATOL = RTOL = 1e-5


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _randomize(module, seed: int):
    """Give every leaf of a reference module random values (LayerNorm
    scale/offset included, which init to ones/zeros)."""
    leaves, treedef = jax.tree_util.tree_flatten(module)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    leaves = [jax.random.normal(k, leaf.shape) * 0.5 + (leaf == 1.0) for k, leaf in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _x(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("use_bias", [True, False])
def test_linear(use_bias):
    ref = _randomize(jnn.Linear.init(jax.random.PRNGKey(0), 6, 5, use_bias=use_bias), 1)
    port = load_jax_params(tnn.Linear(6, 5, use_bias=use_bias), jax_flat(ref))
    x = _x(2, 3, 6)
    _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)))


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_layer_norm_keeps_its_eps(eps):
    ref = _randomize(jnn.LayerNorm.init(12, eps=eps), 3)
    port = load_jax_params(tnn.LayerNorm(12, eps=eps), jax_flat(ref))
    # a tiny variance makes eps matter: a wrong eps fails the tolerance
    x = _x(4, 5, 12) * 0.03
    _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)))


@pytest.mark.parametrize(
    "size,k,stride,padding",
    [(16, 4, 2, "SAME"), (7, 3, 1, "SAME"), (9, 4, 2, "SAME"), (10, 3, 2, "VALID"), (8, 4, 2, 1)],
)
def test_conv2d_padding(size, k, stride, padding):
    ref = _randomize(
        jnn.Conv2d.init(jax.random.PRNGKey(5), 3, 4, k, stride=stride, padding=padding), 6
    )
    port = load_jax_params(tnn.Conv2d(3, 4, k, stride=stride, padding=padding), jax_flat(ref))
    x = _x(7, 2, size, size, 3)
    want = ref(jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("layer_norm,head", [(True, None), (True, 7), (False, 7)])
def test_mlp(layer_norm, head):
    kw = dict(act="silu", layer_norm=layer_norm, use_bias=not layer_norm, norm_eps=1e-3)
    ref = _randomize(jnn.MLP.init(jax.random.PRNGKey(8), 10, [16, 16], head, **kw), 9)
    port = load_jax_params(tnn.MLP(10, [16, 16], head, **kw), jax_flat(ref))
    x = _x(10, 4, 10)
    _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)))


@pytest.mark.parametrize("size,mult", [(64, 2), (16, 4)])
def test_dreamer_cnn(size, mult):
    """The DV3 encoder stack: every stage takes the fused conv_ln_silu path
    (its plain version on the CPU)."""
    kw = dict(act="silu", layer_norm=True, use_bias=False, norm_eps=1e-3)
    chans = [mult * m for m in (1, 2, 4, 8)]
    ref = _randomize(jnn.CNN.init(jax.random.PRNGKey(11), 3, chans, [4] * 4, [2] * 4, **kw), 12)
    port = load_jax_params(tnn.CNN(3, chans, [4] * 4, [2] * 4, **kw), jax_flat(ref))
    x = _x(13, 2, size, size, 3)
    _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)))


def test_cnn_off_the_kernel_path():
    """Odd sizes and biased convs stay on the plain layer-by-layer path."""
    kw = dict(act="relu", layer_norm=False, use_bias=True)
    ref = _randomize(jnn.CNN.init(jax.random.PRNGKey(14), 3, [4, 8], [3, 4], [1, 2], **kw), 15)
    port = load_jax_params(tnn.CNN(3, [4, 8], [3, 4], [1, 2], **kw), jax_flat(ref))
    x = _x(16, 2, 9, 9, 3)
    _close(port(torch.from_numpy(x)), ref(jnp.asarray(x)))


@pytest.mark.parametrize("batch,use_bias", [(4, False), (1, False), (3, True)])
def test_layer_norm_gru_cell(batch, use_bias):
    """Bias-free cells take the fused kernel path (plain version on the CPU);
    a biased cell stays on the module's own path."""
    ref = _randomize(jnn.LayerNormGRUCell.init(jax.random.PRNGKey(17), 6, 8, use_bias=use_bias), 18)
    port = load_jax_params(tnn.LayerNormGRUCell(6, 8, use_bias=use_bias), jax_flat(ref))
    assert port.norm.eps == ref.norm.eps == 1e-5
    x, h = _x(19, batch, 6), _x(20, batch, 8)
    _close(port(torch.from_numpy(x), torch.from_numpy(h)), ref(jnp.asarray(x), jnp.asarray(h)))
