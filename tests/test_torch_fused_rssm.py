"""The fused RSSM step of the port (`ops/kernels/rssm.py`) against the
reference's `fused_rssm_step`, at the sizes of the reference's own fixture
(tests/test_ops/test_pallas.py:_rssm_fixture: R 16, D 12, Hd 10, S 4,
Dd 4, A 3, E 8, B 5), with inputs made by numpy from a seed.

- The plain version against the Pallas kernel run in interpret mode (as
  the reference's tests run it) and against its twin `rssm_step_reference`,
  for all six in-kernel activations: float32 at atol 1e-5 (the same
  products summed in other orders); bfloat16 at atol and rtol 2e-2 (one
  bf16 rounding of an intermediate: z, h', t1 or r1 can round to the
  neighbouring bf16 value, 2^-8 relative).
- The autograd gradients of all 19 inputs against `jax.vjp` through the
  reference's custom VJP, float32, each within 1e-5 of its largest
  magnitude.
- `RSSM.dynamic`'s fused branch against the reference's, with the
  reference's Gumbel draw injected.
- The dispatch guard against the reference's: the four pixel/vector x
  f32/bf16 cases at DreamerV3's default width, and the structures the
  kernel does not take.

The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sheeprl_tpu.ops import pallas_kernels as pk
from sheeprl_tpu_torch.ops.kernels import rssm
from tests.test_torch_interop import jax_flat

R, D, HD, S, DD, A, E, B = 16, 12, 10, 4, 4, 3, 8, 5
EPS = (1e-3, 1e-5, 1e-3)
ACTS = sorted(rssm.ACT_CODES)
MATS = (3, 6, 9, 12, 14, 17)  # the six weight matrices among the 19 inputs
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def pallas_interpret():
    pk.set_pallas(True, interpret=True)
    yield
    pk.set_pallas(None, interpret=False)


def _inputs(seed: int) -> list[np.ndarray]:
    """x, h, emb and the 16 weights of one step, matrices in the reference's
    [in, out] layout, all float32."""
    rng = np.random.default_rng(seed)
    dx = S * DD + A

    def mat(i, o):
        return (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)

    def vec(n, base=0.0, scale=0.1):
        return (base + scale * rng.normal(size=(n,))).astype(np.float32)

    return [
        rng.normal(size=(B, dx)).astype(np.float32),
        np.tanh(rng.normal(size=(B, R))).astype(np.float32),
        rng.normal(size=(B, E)).astype(np.float32),
        mat(dx, D), vec(D, 1.0), vec(D),
        mat(D + R, 3 * R), vec(3 * R, 1.0), vec(3 * R),
        mat(R, HD), vec(HD, 1.0), vec(HD),
        mat(HD, S * DD), vec(S * DD),
        mat(R + E, HD), vec(HD, 1.0), vec(HD),
        mat(HD, S * DD), vec(S * DD),
    ]


def _split(arrays, dtype_name):
    """-> (jax arrays, torch tensors in the port's layout): x, h, emb and the
    matrices in the compute dtype (the same bf16 values on both sides),
    the LN affines and biases float32."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    jx, tx = [], []
    for i, a in enumerate(arrays):
        low = i < 3 or i in MATS
        jx.append(jnp.asarray(a, jdt) if low else jnp.asarray(a))
        t = torch.from_numpy(np.ascontiguousarray(a.T if i in MATS else a))
        tx.append(t.to(tdt) if low else t)
    return jx, tx


def _np(t) -> np.ndarray:
    return (t.detach().float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(jnp.asarray(t, jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_pallas_kernel_and_twin(pallas_interpret, dtype, act):
    jx, tx = _split(_inputs(ACTS.index(act)), dtype)
    kernel = pk.fused_rssm_step(*jx, act, EPS)
    twin = pk.rssm_step_reference(*jx, act, EPS)
    got = rssm.fused_rssm_step(*tx, act, EPS)
    assert got[0].dtype == tx[0].dtype and got[1].dtype == got[2].dtype == torch.float32
    tol = TOL[dtype]
    for g, k, t, name in zip(got, kernel, twin, ("h'", "prior_raw", "post_raw")):
        np.testing.assert_allclose(_np(g), _np(k), atol=tol, rtol=0 if dtype == "float32" else tol,
                                   err_msg=f"{name} vs the Pallas kernel")
        np.testing.assert_allclose(_np(g), _np(t), atol=tol, rtol=0 if dtype == "float32" else tol,
                                   err_msg=f"{name} vs the twin")


@pytest.mark.parametrize("act", ["silu", "gelu", "elu"])
def test_gradients_match_custom_vjp(pallas_interpret, act):
    arrays = _inputs(10 + ACTS.index(act))
    rng = np.random.default_rng(99)
    cots = [rng.normal(size=(B, R)), rng.normal(size=(B, S * DD)), rng.normal(size=(B, S * DD))]
    cots = [c.astype(np.float32) for c in cots]
    jx, tx = _split(arrays, "float32")
    _, vjp = jax.vjp(lambda *a: pk.fused_rssm_step(*a, act, EPS), *jx)
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    leaves = [t.clone().requires_grad_(True) for t in tx]
    outs = rssm.fused_rssm_step(*leaves, act, EPS)
    got = torch.autograd.grad(outs, leaves, [torch.from_numpy(c) for c in cots])
    assert len(got) == len(want) == 19
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w).T if i in MATS else np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * scale, (i, float(np.abs(g.numpy() - w).max()), scale)


def _rssm_pair(seed: int, act: str = "silu", biased_gru: bool = False):
    """The reference's RSSM at the fixture's sizes, every parameter moved by
    numpy noise, and the port's RSSM carrying the same parameters."""
    from sheeprl_tpu import nn as jnn
    from sheeprl_tpu.algos.dreamer_v3.agent import RSSM as JRSSM
    from sheeprl_tpu.algos.dreamer_v3.agent import RecurrentModel as JRecurrentModel
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import RSSM, RecurrentModel
    from sheeprl_tpu_torch.interop import load_jax_params
    from sheeprl_tpu_torch.nn.blocks import MLP

    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    kw = dict(act=act, layer_norm=True, use_bias=False, norm_eps=1e-3)
    rm = JRecurrentModel.init(ks[0], S * DD + A, R, D, layer_norm=True, activation=act)
    if biased_gru:
        rm = rm.replace(rnn=rm.rnn.replace(proj=jnn.Linear.init(ks[3], D + R, 3 * R, use_bias=True)))
    ref = JRSSM(
        recurrent_model=rm,
        representation_model=jnn.MLP.init(ks[1], R + E, [HD], S * DD, **kw),
        transition_model=jnn.MLP.init(ks[2], R, [HD], S * DD, **kw),
        discrete=DD, unimix=0.01,
    )
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(ref)
    ref = jax.tree_util.tree_unflatten(
        tree, [l + jnp.asarray(0.1 * rng.normal(size=l.shape), l.dtype) for l in leaves]
    )
    port_rm = RecurrentModel(S * DD + A, R, D, layer_norm=True, activation=act)
    if biased_gru:
        from sheeprl_tpu_torch.nn.recurrent import LayerNormGRUCell

        port_rm.rnn = LayerNormGRUCell(D, R, use_bias=True)
    port = RSSM(port_rm, MLP(R + E, [HD], S * DD, **kw), MLP(R, [HD], S * DD, **kw), discrete=DD, unimix=0.01)
    load_jax_params(port, jax_flat(ref))
    return ref, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dynamic_fused_branch_matches_reference(pallas_interpret, dtype):
    ref, port = _rssm_pair(3)
    rng = np.random.default_rng(4)
    post = np.eye(DD, dtype=np.float32)[rng.integers(0, DD, (B, S))]
    rec = np.tanh(rng.normal(size=(B, R))).astype(np.float32)
    act = np.eye(A, dtype=np.float32)[rng.integers(0, A, B)]
    emb = rng.normal(size=(B, E)).astype(np.float32)
    first = np.array([[1.0], [0.0], [0.0], [1.0], [0.0]], np.float32)
    key = jax.random.PRNGKey(11)
    gumbel = jax.random.gumbel(jax.random.split(key)[1], (B, S, DD))  # the reference's posterior draw
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x_ref = jnp.concatenate([jnp.asarray(post, jdt).reshape(B, -1), jnp.asarray(act, jdt)], -1)
    assert ref._fused_step_weights(x_ref, jnp.asarray(emb, jdt)) is not None
    assert port._fused_step_weights(tdt) is not None
    want = ref.dynamic(*(jnp.asarray(a, jdt) for a in (post, rec, act, emb)), jnp.asarray(first), key)
    w_rec, w_post, _, w_post_logits, w_prior_logits = want
    before = rssm.fused_rssm_step.launches
    with torch.no_grad():
        got = port.dynamic(*(torch.from_numpy(a).to(tdt) for a in (post, rec, act, emb)),
                           torch.from_numpy(first), torch.from_numpy(np.array(gumbel)))
    assert rssm.fused_rssm_step.launches == before  # CPU tensors take the plain version
    g_rec, g_post, g_prior_logits, g_post_logits = got
    assert g_rec.dtype == g_post.dtype == tdt and g_post_logits.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(g_rec), _np(w_rec), atol=tol, rtol=0 if dtype == "float32" else tol)
    np.testing.assert_allclose(_np(g_prior_logits), _np(w_prior_logits), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(g_post_logits), _np(w_post_logits), atol=tol, rtol=tol)
    # one-hot draws (straight-through: sample + probs - probs, exact to 1e-7)
    np.testing.assert_allclose(_np(g_post), _np(w_post), atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["biased_gru", "unsupported_act"])
def test_guard_refuses_what_the_reference_refuses(pallas_interpret, case):
    """The structures outside the kernel's contract (the reference's
    `test_fused_rssm_dispatch_falls_back_on_mismatch`, and an activation
    without an in-kernel form): both guards refuse and the unfused branch
    runs."""
    ref, port = _rssm_pair(5, act="sigmoid" if case == "unsupported_act" else "silu",
                           biased_gru=case == "biased_gru")
    x = jnp.zeros((B, S * DD + A))
    assert ref._fused_step_weights(x, jnp.zeros((B, E))) is None
    assert port._fused_step_weights(torch.float32) is None
    rng = np.random.default_rng(6)
    with torch.no_grad():
        out = port.dynamic(torch.zeros(B, S, DD), torch.zeros(B, R), torch.zeros(B, A),
                           torch.from_numpy(rng.normal(size=(B, E)).astype(np.float32)),
                           torch.zeros(B, 1), torch.zeros(B, S, DD))
    assert all(bool(torch.isfinite(o.float()).all()) for o in out)


@pytest.mark.parametrize("obs", ["pixels", "vector"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guard_matches_reference_at_default_width(obs, dtype):
    """At DreamerV3's default width only vector observations in bf16 fit the
    10 MiB budget; the port's guard decides as the reference's does on the
    same weights."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_models
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.envs import spaces

    if obs == "pixels":
        space, cnn_keys, mlp_keys = {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}, ["rgb"], []
    else:
        space, cnn_keys, mlp_keys = {"state": spaces.Box(-np.inf, np.inf, (4,))}, [], ["state"]
    wm, _, _, _ = build_models(torch.Generator().manual_seed(0), [2], False, DreamerV3Args(), space,
                               cnn_keys, mlp_keys)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    fused = wm.rssm._fused_step_weights(tdt)
    rm, tm, pm = wm.rssm.recurrent_model, wm.rssm.transition_model, wm.rssm.representation_model
    tensors = [rm.mlp.layers[0].weight, rm.mlp.norms[0].scale, rm.mlp.norms[0].offset, rm.rnn.proj.weight,
               rm.rnn.norm.scale, rm.rnn.norm.offset, tm.layers[0].weight, tm.norms[0].scale, tm.norms[0].offset,
               tm.head.weight, tm.head.bias, pm.layers[0].weight, pm.norms[0].scale, pm.norms[0].offset,
               pm.head.weight, pm.head.bias]
    ref_weights = [jnp.asarray(t.detach().numpy().T, jdt) if i in (0, 3, 6, 9, 11, 14)
                   else jnp.asarray(t.detach().numpy()) for i, t in enumerate(tensors)]
    fits = pk.fused_rssm_supported("silu", *ref_weights)
    assert fits == (obs == "vector" and dtype == "bfloat16")
    assert (fused is not None) == fits
    if fused is not None:
        weights, act, eps = fused
        assert act == "silu" and eps == (1e-3, 1e-5, 1e-3)
        assert [weights[i].dtype for i in (0, 3, 6, 9, 11, 14)] == [tdt] * 6
        assert weights[1].dtype == weights[15].dtype == torch.float32
