"""The port's Adam (`ops/optim.py:Adam`) against optax on the CPU, at
parameter shapes of a few sizes, with gradients made from seeds by numpy:

  - `optax.chain(clip_by_global_norm, adam(lr, eps))`, the DreamerV3 and
    SAC chain (no clip for SAC's), over 100 steps: parameters at atol 1e-7
    / rtol 1e-7, both moments at rtol 1e-6 / atol 1e-7. Both sides run
    optax's order in f32, but XLA's CPU code may contract `(1 - b) * g**k
    + b * moment` into one fused multiply-add where the port rounds twice
    (a few ulps in the second moment after 100 steps), and `b ** count` is
    each library's own f32 `pow`, an ulp apart at some counts (the first
    at 31 for b = 0.9). PyTorch's default Adam (the port's optimizer
    before), run on the same gradients, must part from optax by more than
    the port's Adam does (both gaps printed);
  - PPO's `scale_by_adam` chain with its traced lr (`-lr * u` with a
    scalar that changes every step) against the lr as a device tensor: the
    same tolerance;
  - a state saved and loaded again, also a state saved by PyTorch's Adam
    (the optimizer of checkpoints written before this Adam): step counts
    come back as f32 tensors on the parameters' device, PyTorch's extra
    settings are dropped, and the loaded optimizer steps as the saved one;
  - `compile/plan.py:_Untouched` resets the state a warm-up created to a
    fresh optimizer's, and the next step equals a fresh optimizer's first.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

SHAPES = [(7, 5), (5,), (3, 4, 2), (1,)]
TOL = dict(atol=1e-7, rtol=1e-7)
MOMENT_TOL = dict(atol=1e-7, rtol=1e-6)


def _grads(rng, step: int) -> list[np.ndarray]:
    # every 7th step a large gradient, so the clip acts on some steps
    scale = 10.0 if step % 7 == 0 else 0.1
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in SHAPES]


def _port(params: list[np.ndarray], lr, eps: float):
    from sheeprl_tpu_torch.ops.optim import Adam

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    return tp, Adam(tp, lr=lr, eps=eps)


def _step(tp, opt, grads, clip):
    from sheeprl_tpu_torch.ops.optim import apply_gradients

    apply_gradients(tp, [torch.from_numpy(g) for g in grads], opt, clip)


def _assert_state(tp, opt, params, adam_state):
    for i, p in enumerate(tp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[i]), **TOL)
        st = opt.state[p]
        assert st["step"].dtype == torch.float32 and st["step"].device == p.device
        assert float(st["step"]) == int(adam_state.count)
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(adam_state.mu[i]), **MOMENT_TOL)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(adam_state.nu[i]), **MOMENT_TOL)


@pytest.mark.parametrize("clip,lr,eps", [(None, 3e-4, 1e-4), (1.0, 1e-4, 1e-8), (100.0, 8e-5, 1e-5)])
def test_adam_matches_optax_adam_over_100_steps(clip, lr, eps):
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(0)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    tx = optax.adam(lr, eps=eps)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp, opt = _port(params, lr, eps)
    plain = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    plain_opt = torch.optim.Adam(plain, lr=lr, eps=eps)
    for i in range(100):
        grads = _grads(rng, i)
        updates, state = update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, updates)
        _step(tp, opt, grads, clip)
        _step(plain, plain_opt, grads, clip)
    adam_state = next(s for s in jax.tree_util.tree_leaves(state, is_leaf=lambda s: hasattr(s, "mu"))
                      if hasattr(s, "mu"))
    _assert_state(tp, opt, jp, adam_state)
    gaps = [max(float(np.abs(p.detach().numpy() - np.asarray(w)).max()) for p, w in zip(ps, jp)) for ps in (tp, plain)]
    print(f"parameters after 100 steps, largest gap to optax: the port's Adam {gaps[0]:.3e}, PyTorch's {gaps[1]:.3e}")
    assert gaps[0] < gaps[1]


def test_adam_matches_ppo_scale_by_adam_with_a_traced_lr():
    """PPO's chain (`sheeprl_tpu/algos/ppo/ppo.py:115`, clip 0.5 then
    `scale_by_adam(eps)`, then `-lr * u` with the annealed lr traced) against
    the port's Adam reading the lr from a device scalar it is given anew
    each step."""
    import jax
    import jax.numpy as jnp
    import optax

    from sheeprl_tpu.algos.ppo.args import PPOArgs
    from sheeprl_tpu.algos.ppo.ppo import make_optimizer

    args = PPOArgs(max_grad_norm=0.5, eps=1e-5)
    tx = make_optimizer(args)
    rng = np.random.default_rng(1)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)

    @jax.jit
    def step(jp, state, grads, lr):
        updates, state = tx.update(grads, state, jp)
        return optax.apply_updates(jp, jax.tree_util.tree_map(lambda u: -lr * u, updates)), state

    tp, opt = _port(params, 2.5e-4, args.eps)
    for i in range(100):
        lr = np.float32(2.5e-4 * (1 - i / 100))
        grads = _grads(rng, i)
        jp, state = step(jp, state, [jnp.asarray(g) for g in grads], jnp.float32(lr))
        for group in opt.param_groups:
            group["lr"] = torch.tensor(lr)
        _step(tp, opt, grads, args.max_grad_norm)
    _assert_state(tp, opt, jp, state[1])


def _run(tp, opt, rng, steps, clip=None):
    for i in range(steps):
        _step(tp, opt, _grads(rng, i), clip)


def test_adam_state_saves_and_loads_and_pytorch_adam_states_load():
    from sheeprl_tpu_torch.ops.optim import load_optimizer_state

    rng = np.random.default_rng(2)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    tp, opt = _port(params, 1e-3, 1e-8)
    _run(tp, opt, np.random.default_rng(3), 5)
    saved = copy.deepcopy(opt.state_dict())  # as a checkpoint holds it
    assert isinstance(saved["param_groups"][0]["lr"], float)
    # the same state in a fresh optimizer steps as the original
    tp2, opt2 = _port([p.detach().numpy() for p in tp], 1e-3, 1e-8)
    load_optimizer_state(opt2, saved)
    for a, b in ((tp, opt), (tp2, opt2)):
        _run(a, b, np.random.default_rng(4), 3)
    for a, b in zip(tp, tp2):
        assert torch.equal(a, b)

    # a state PyTorch's Adam wrote (host step counts, its own settings)
    ref = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    torch_adam = torch.optim.Adam(ref, lr=1e-3, eps=1e-8)
    _run(ref, torch_adam, np.random.default_rng(3), 5)
    tp3, opt3 = _port([p.detach().numpy() for p in ref], 1e-3, 1e-8)
    load_optimizer_state(opt3, copy.deepcopy(torch_adam.state_dict()))
    assert set(opt3.param_groups[0]) == {"params", "lr", "betas", "eps"}
    for p, r in zip(tp3, ref):
        st = opt3.state[p]
        assert st["step"].dtype == torch.float32 and st["step"].device == p.device and float(st["step"]) == 5
        assert torch.equal(st["exp_avg"], torch_adam.state[r]["exp_avg"])
    _run(tp3, opt3, np.random.default_rng(4), 1)
    assert all(float(opt3.state[p]["step"]) == 6 for p in tp3)


def test_untouched_resets_the_adam_a_warm_up_created():
    from sheeprl_tpu_torch.compile.plan import CompilePlan
    from sheeprl_tpu_torch.ops.optim import Adam

    def step(model, optimizer, x, lr):
        for group in optimizer.param_groups:
            group["lr"] = lr
        loss = model(x).square().sum()
        params = list(model.parameters())
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Tanh(), torch.nn.Linear(4, 2))
    fresh = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Tanh(), torch.nn.Linear(4, 2))
    fresh.load_state_dict(model.state_dict())
    opt, fresh_opt = Adam(model.parameters(), lr=0.1, eps=1e-4), Adam(fresh.parameters(), lr=0.1, eps=1e-4)
    plan = CompilePlan(enabled=True, mode="static")
    lr = torch.tensor(0.05)
    wj = plan.register("step", step, example=lambda: (model, opt, torch.ones(5, 3), torch.tensor(0.2)))
    plan.start()
    for st in opt.state.values():
        assert st["step"].dtype == torch.float32 and float(st["step"]) == 0
        assert not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        x = torch.randn(5, 3, generator=gen)
        assert torch.equal(wj(model, opt, x, lr), step(fresh, fresh_opt, x, lr))
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
