"""Carry the reference's parameters into the port.

The input is the JAX package's parameters as numpy arrays keyed by the JAX
module's field path (`rssm.recurrent_model.rnn.proj.weight`), flat or as
nested dicts. The port's modules use the same paths, so the mapping is one
to one: the player, the world model with its decoders (the MLP decoder's
heads are keyed by observation key, a `ModuleDict` here), the actor, the
critic and the target critic; the SAC actor (with its `action_scale` and
`action_bias`), and a quantized actor, whose `QuantLinear`s keep their int8
`w_q` and f32 scales. The only change of layout is `Linear.weight` and
`QuantLinear.w_q`, which the reference keeps as [in, out] and the port as
[out, in]. Conv and transposed-conv kernels stay HWIO (the port keeps
NHWC/HWIO at its convolutions). The port never imports jax: the caller
flattens the JAX pytree.

A whole reference checkpoint comes across too. The caller restores it with
the reference's `load_checkpoint` (a tree of dicts, lists and numpy
arrays, `None` where a module has no parameter) and hands the tree over:

  - `dreamer_v3_checkpoint_from_jax` returns the port's DreamerV3
    checkpoint (the key contract of `algos/dreamer_v3/dreamer_v3.py:
    checkpoint_state`): the parameters through `state_dict_from_jax`, each
    optax Adam state (`ScaleByAdamState`, behind the clip transform's empty
    state) as the port's `Adam`'s state_dict (`adam_state_from_jax`), the
    moments and the counters;
  - `dreamer_v2_checkpoint_from_jax` and `dreamer_v1_checkpoint_from_jax`
    do the same for DreamerV2 (no moments) and DreamerV1 (no target critic
    either): their Adam states sit behind the clip's and, in V2's chain,
    `add_decayed_weights`' empty states. DreamerV1's `GRUCell` is two
    Linears, transposed as every Linear is;
  - `p2e_checkpoint_from_jax` does the same for Plan2Explore on either:
    both behaviours, the ensembles (stacked on both sides, their weights
    `[n, in, out]` in both, as the SAC critics') and six Adam states;
  - `sac_checkpoint_from_jax` returns the port's SAC or DroQ checkpoint
    (the key contract of `algos/sac/sac.py:checkpoint_state`): the actor,
    the critics and the target critics through `state_dict_from_jax`,
    `log_alpha`, and the three optax Adam states through
    `adam_state_from_jax`. The critics' members are stacked on both sides,
    their weights `[n, in, out]` in both (no transposition);
  - `ppo_checkpoint_from_jax` returns the port's PPO checkpoint (the keys
    `agent`, `optimizer`, `update_step` of `algos/ppo/ppo.py:main`): the
    agent through `ppo_agent_from_jax`, its optax Adam state (behind the
    clip transform's empty state when `max_grad_norm` > 0) through
    `adam_state_from_jax`.

The device envs' states come across too (the tests start both packages'
envs and collectors from the same state with them): the reference's
env-state, `VecEnvState` and collector-carry pytrees, as numpy arrays keyed
by field path (flat, `vec.env_state.state`, or nested dicts), become the
port's dataclasses of tensors (`env_state_from_jax`,
`vec_env_state_from_jax`, `collector_carry_from_jax`). The field names are
the reference's, so the mapping is one to one; no layout changes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
import torch.nn as tnn

from .nn.layers import Linear
from .ops.quant import QuantLinear

__all__ = [
    "adam_state_from_jax", "collector_carry_from_jax", "dreamer_v1_checkpoint_from_jax",
    "dreamer_v2_checkpoint_from_jax", "dreamer_v3_checkpoint_from_jax", "env_state_from_jax",
    "flatten_params", "load_jax_params", "p2e_checkpoint_from_jax", "ppo_agent_from_jax", "ppo_checkpoint_from_jax",
    "sac_checkpoint_from_jax",
    "state_dict_from_jax", "vec_env_state_from_jax",
]


def flatten_params(params, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts and lists of arrays -> {dotted path: array}; a list's
    items are keyed by index (`layers.0.weight`), `None` leaves (a module's
    absent bias or norm) are dropped."""
    flat: dict[str, np.ndarray] = {}
    items = params.items() if isinstance(params, Mapping) else enumerate(params)
    for key, value in items:
        path = f"{prefix}{key}"
        if value is None:
            continue
        if isinstance(value, (Mapping, list, tuple)):
            flat.update(flatten_params(value, path + "."))
        else:
            flat[path] = np.asarray(value)
    return flat


def _transposed(module: tnn.Module) -> set[str]:
    """The paths whose layout the port transposes: `Linear.weight` and
    `QuantLinear.w_q` ([in, out] in the reference, [out, in] here)."""
    def path(name: str, leaf: str) -> str:
        return f"{name}.{leaf}" if name else leaf

    out = {path(name, "weight") for name, m in module.named_modules() if isinstance(m, Linear)}
    return out | {path(name, "w_q") for name, m in module.named_modules() if isinstance(m, QuantLinear)}


def _port_tensor(name: str, value: np.ndarray, ref: torch.Tensor, transposed: set[str]) -> torch.Tensor:
    value = value.T if name in transposed else value
    if tuple(value.shape) != tuple(ref.shape):
        raise ValueError(f"{name}: reference shape {tuple(np.shape(value))} does not map onto the port's "
                         f"{tuple(ref.shape)}")
    return torch.from_numpy(np.array(value)).to(dtype=ref.dtype, device=ref.device)


def state_dict_from_jax(module: tnn.Module, params: Mapping) -> dict[str, torch.Tensor]:
    """The port `module`'s state_dict filled from the reference's `params`.
    Raises, naming the paths, on a reference parameter the port has no place
    for, on a port parameter the reference leaves unset, and on a shape that
    does not match."""
    flat = flatten_params(params)
    own = module.state_dict()
    unmapped = sorted(set(flat) - set(own))
    if unmapped:
        raise KeyError(f"reference parameters with no counterpart in the port: {unmapped}")
    unset = sorted(set(own) - set(flat))
    if unset:
        raise KeyError(f"port parameters the reference leaves unset: {unset}")
    transposed = _transposed(module)
    return {name: _port_tensor(name, flat[name], ref, transposed) for name, ref in own.items()}


def load_jax_params(module: tnn.Module, params: Mapping) -> tnn.Module:
    """Load the reference's `params` into `module` in place; returns it."""
    module.load_state_dict(state_dict_from_jax(module, params))
    return module


def _adam_of(opt_state) -> Mapping:
    """The one `ScaleByAdamState` (a dict with `count`, `mu`, `nu`) in an
    optax state tree."""
    found = []

    def walk(node):
        if isinstance(node, Mapping) and {"count", "mu", "nu"} <= set(node):
            found.append(node)
        elif isinstance(node, (Mapping, list, tuple)):
            for item in (node.values() if isinstance(node, Mapping) else node):
                walk(item)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one Adam state (count, mu, nu) in the optimizer state, found {len(found)}")
    return found[0]


def adam_state_from_jax(module: tnn.Module, optimizer: torch.optim.Optimizer, opt_state) -> dict:
    """`optimizer`'s state_dict (an `ops/optim.py:Adam` over
    `module.parameters()`) filled from the reference's optax state of the
    same module: `mu` -> `exp_avg`, `nu` -> `exp_avg_sq`, each laid out as
    its parameter (the weight's transposition), and `count` -> every
    parameter's `step`. The moments of a leaf the port keeps as a buffer
    (the SAC actor's action bounds, which the reference never moves) are
    dropped. Both sides count the updates taken, so the bias
    corrections 1 - beta**step are the same."""
    adam = _adam_of(opt_state)
    mu, nu = flatten_params(adam["mu"]), flatten_params(adam["nu"])
    params = dict(module.named_parameters())
    buffers = {name for name, _ in module.named_buffers()}
    for side, flat in (("mu", mu), ("nu", nu)):
        if set(flat) - buffers != set(params):
            raise KeyError(f"the Adam {side} paths differ from the module's parameters: "
                           f"{sorted((set(flat) - buffers) ^ set(params))}")
    names = {id(p): name for name, p in params.items()}
    order = [names[id(p)] for group in optimizer.param_groups for p in group["params"]]
    transposed = _transposed(module)
    step = float(np.asarray(adam["count"]))
    state = {
        i: {"step": torch.tensor(step), "exp_avg": _port_tensor(name, mu[name], params[name].detach(), transposed),
            "exp_avg_sq": _port_tensor(name, nu[name], params[name].detach(), transposed)}
        for i, name in enumerate(order)
    }
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def _dreamer_checkpoint_from_jax(tree: Mapping, state) -> dict:
    """The models, the Adam states and the counters of a Dreamer-family
    checkpoint, laid out for `state` (its fields give the keys, by
    `algos/dreamer_v2/dreamer_v2.py:checkpoint_fields`; its modules and
    optimizers the paths and the order)."""
    from .algos.dreamer_v2.dreamer_v2 import checkpoint_fields

    out: dict = {}
    for key, name, module in checkpoint_fields(state):
        if module is None and isinstance(getattr(state, name), tnn.Module):
            out[key] = state_dict_from_jax(getattr(state, name), tree[key])
        elif module is None:  # DreamerV3's return normalizer: its caller's
            continue
        else:
            out[key] = adam_state_from_jax(getattr(state, module), getattr(state, name), tree[key])
    for key in ("expl_decay_steps", "global_step", "batch_size"):
        out[key] = int(np.asarray(tree[key]))
    return out


def dreamer_v3_checkpoint_from_jax(tree: Mapping, state) -> dict:
    """A reference DreamerV3 checkpoint (the restored tree) -> the port's
    checkpoint dict, laid out for `state` (a `DV3TrainState` built with the
    same config: its modules and optimizers give the paths and the order)."""
    out = _dreamer_checkpoint_from_jax(tree, state)
    out["moments"] = {k: torch.tensor(np.asarray(tree["moments"][k], np.float32)) for k in ("low", "high")}
    return out


def dreamer_v2_checkpoint_from_jax(tree: Mapping, state) -> dict:
    """A reference DreamerV2 checkpoint (the restored tree, key contract
    `sheeprl_tpu/algos/dreamer_v2/dreamer_v2.py:791-806`) -> the port's,
    laid out for `state` (a `DV2TrainState` built with the same config)."""
    return _dreamer_checkpoint_from_jax(tree, state)


def dreamer_v1_checkpoint_from_jax(tree: Mapping, state) -> dict:
    """A reference DreamerV1 checkpoint (the restored tree, the V2 contract
    without `target_critic`) -> the port's, laid out for `state` (a
    `DV1TrainState` built with the same config)."""
    return _dreamer_checkpoint_from_jax(tree, state)


def p2e_checkpoint_from_jax(tree: Mapping, state) -> dict:
    """A reference Plan2Explore checkpoint, on DreamerV1 or V2 (the restored
    tree, key contract `tests/test_algos/test_p2e.py:30-36`, V2's with both
    target critics) -> the port's, laid out for `state` (a
    `P2EDV1TrainState` or `P2EDV2TrainState` built with the same config):
    both behaviours, the ensembles (their stacked `[n, in, out]` weights
    as they are, as the SAC critics') and the six Adam states."""
    return _dreamer_checkpoint_from_jax(tree, state)


def sac_checkpoint_from_jax(tree: Mapping, state, seed: int = 0) -> dict:
    """A reference SAC or DroQ checkpoint (the restored tree, key contract
    `sheeprl_tpu/algos/sac/sac.py:452-458`, `droq.py`'s the same) -> the
    port's checkpoint dict, laid out for `state` (a `SACTrainState` whose
    agent, a `SACAgent` or `DROQAgent`, and Adams are built with the same
    config). The generator state the port's checkpoint adds is a fresh
    CPU generator's, seeded `seed`: the reference's JAX key cannot be
    carried."""
    agent, ref = state.agent, tree["agent"]
    alpha = _adam_of(tree["alpha_optimizer"])
    alpha_state = {"step": torch.tensor(float(np.asarray(alpha["count"]))),
                   **{k: torch.from_numpy(np.array(alpha[j], np.float32)).reshape(agent.log_alpha.shape)
                      for k, j in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}}
    return {
        "agent": {**{k: state_dict_from_jax(getattr(agent, k), ref[k]) for k in ("actor", "critics", "target_critics")},
                  "log_alpha": torch.from_numpy(np.array(ref["log_alpha"], np.float32))},
        "qf_optimizer": adam_state_from_jax(agent.critics, state.qf_opt, tree["qf_optimizer"]),
        "actor_optimizer": adam_state_from_jax(agent.actor, state.actor_opt, tree["actor_optimizer"]),
        "alpha_optimizer": {"state": {0: alpha_state}, "param_groups": state.alpha_opt.state_dict()["param_groups"]},
        "global_step": int(np.asarray(tree["global_step"])),
        "generator": torch.Generator().manual_seed(seed).get_state(),
    }


def ppo_agent_from_jax(agent: tnn.Module, params: Mapping) -> tnn.Module:
    """Load a reference `PPOAgent`'s parameters (its flattened pytree:
    encoders, actor backbone, heads, critic) into the port's `agent`, built
    with the same config; returns it."""
    return load_jax_params(agent, params)


def ppo_checkpoint_from_jax(tree: Mapping, agent: tnn.Module, optimizer: torch.optim.Optimizer,
                            seed: int = 0) -> dict:
    """A reference PPO checkpoint (the restored tree, key contract
    `sheeprl_tpu/algos/ppo/ppo.py:811-830`) -> the port's checkpoint dict,
    laid out for `agent` and `optimizer` (an `ops/optim.py:Adam` over
    `agent.parameters()`, built with the same config). The generator state
    the port's checkpoint adds is a fresh generator's, seeded `seed`: the
    reference's JAX key cannot be carried."""
    return {
        "agent": state_dict_from_jax(agent, tree["agent"]),
        "optimizer": adam_state_from_jax(agent, optimizer, tree["optimizer"]),
        "update_step": int(np.asarray(tree["update_step"])),
        "generator": torch.Generator().manual_seed(seed).get_state(),
    }


def _sub(flat: dict[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _tensor(value: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(value)).to(device)


def env_state_from_jax(env, tree: Mapping, device="cpu"):
    """A reference env-state pytree (`CartPoleState`, `PendulumState`,
    `PixelToyState`; one env's or a batch's) -> `env.State` (the port's
    device env `env`) with the same arrays as tensors on `device`."""
    import dataclasses

    flat = flatten_params(tree)
    names = [f.name for f in dataclasses.fields(env.State)]
    if set(flat) != set(names):
        raise KeyError(f"reference env state {sorted(flat)} does not map onto {env.State.__name__} {names}")
    return env.State(**{n: _tensor(flat[n], device) for n in names})


def vec_env_state_from_jax(env, tree: Mapping, device="cpu"):
    """A reference `VecEnvState` pytree (`env_state`, `ep_return`,
    `ep_length`) -> the port's `VecEnvState` over `env.State`."""
    from .envs.device.core import VecEnvState

    flat = flatten_params(tree)
    return VecEnvState(env_state=env_state_from_jax(env, _sub(flat, "env_state."), device),
                       ep_return=_tensor(flat["ep_return"], device), ep_length=_tensor(flat["ep_length"], device))


def collector_carry_from_jax(env, tree: Mapping, device="cpu"):
    """A reference collector carry (`PPOCollectorCarry`: `vec`, `obs`,
    `prev_done`; `DreamerCollectorCarry`: also `prev_reward` and
    `is_first`) -> the port's carry of the same kind."""
    from .envs.device.rollout import DreamerCollectorCarry, PPOCollectorCarry

    flat = flatten_params(tree)
    common = dict(vec=vec_env_state_from_jax(env, _sub(flat, "vec."), device),
                  obs={k: _tensor(v, device) for k, v in _sub(flat, "obs.").items()},
                  prev_done=_tensor(flat["prev_done"], device))
    if "prev_reward" in flat:
        return DreamerCollectorCarry(**common, prev_reward=_tensor(flat["prev_reward"], device),
                                     is_first=_tensor(flat["is_first"], device))
    return PPOCollectorCarry(**common)
