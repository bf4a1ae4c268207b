"""The batched device-env API (the port of sheeprl_tpu/envs/jax/core.py).

An environment here is N copies stepped as one batch of torch tensors on
the run's device: a state dataclass whose every field is a tensor with the
env batch as its leading dimension, and three functions over it,

    env.draw_resets(generator, lead)  -> State, fresh reset states [*lead, ...]
    env.observe(state)                -> obs dict
    env.step(state, actions)          -> (State, obs, reward, terminated, truncated)

The reference writes each env for one copy and lifts it with `jax.vmap`;
the port writes the batch out, so one step of N envs is a few tensor
kernels whatever N is. Observations are dicts keyed as the host pipeline
keys them (`"state"` for vectors, `"rgb"` for uint8 NHWC pixels), so the
agents and encoders run unchanged on either backend; actions arrive in the
env-native layout (`int32 [N]` for `Discrete`, `f32 [N, act_dim]` for
`Box`).

`VecDeviceEnv` adds the reference's same-step auto-reset (`core.py:
115-147`): where an episode ends, the returned observation is already the
reset one, the pre-reset observation rides in `info["final_obs"]`, and the
running episode return and length (`VecEnvState`) are reported in `info`
and zeroed. Randomness is passed in: `draw_resets(generator, T)` draws the
fresh states of T steps of N envs in one go, and `step(state, actions,
fresh)` takes one step's slice of them, so a whole rollout can be replayed
as one CUDA graph with its draws made outside it.

The state trees (dataclasses, dicts and tensors) are walked by
`tree_map`, `tree_select` (the auto-reset primitive), `tree_copy_` (a
carry updated in place, as a graph needs) and `tree_state_dict` /
`tree_load_` (a carry in a checkpoint).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

__all__ = [
    "DeviceEnv", "VecDeviceEnv", "VecEnvState", "tree_copy_", "tree_index", "tree_load_", "tree_map",
    "tree_select", "tree_state_dict",
]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the tensors of `tree` (dataclasses, dicts, tuples and
    lists of tensors), with the matching leaves of `rest` as its further
    arguments; the result keeps `tree`'s structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: tree_map(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest))
                             for f in dataclasses.fields(tree)})
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_select(mask: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """Per-env select between two trees of the same structure: `mask` is
    `[N]` bool (or 0/1 float), broadcast against each leaf's trailing
    dims. Where it is set the leaf of `on_true` is taken."""
    mask = mask.to(torch.bool)

    def one(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())), a, b)

    return tree_map(one, on_true, on_false)


def tree_index(tree: Any, i) -> Any:
    """Every leaf indexed by `i` along its leading dim (one step's slice of
    a `[T, N, ...]` draw)."""
    return tree_map(lambda t: t[i], tree)


def tree_copy_(dst: Any, src: Any) -> None:
    """Copy `src`'s leaves into `dst`'s tensors in place (the same
    structure): a carry that keeps its tensors, as a graph reads them."""
    with torch.no_grad():
        tree_map(lambda d, s: d.copy_(s), dst, src)


def tree_state_dict(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """{dotted path: tensor} of a tree (a carry's checkpoint form)."""
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))
    else:
        raise TypeError(f"not a tree of tensors: {type(tree).__name__}")
    out: dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(tree_state_dict(v, f"{prefix}{k}."))
    return out


def tree_load_(tree: Any, state: dict[str, torch.Tensor]) -> None:
    """Load what `tree_state_dict` wrote into `tree`'s tensors in place
    (from any device). Raises on a missing, extra or reshaped leaf."""
    own = tree_state_dict(tree)
    if set(own) != set(state):
        raise KeyError(f"carry keys differ: missing {sorted(set(own) - set(state))}, "
                       f"unexpected {sorted(set(state) - set(own))}")
    with torch.no_grad():
        for k, t in own.items():
            if tuple(state[k].shape) != tuple(t.shape) or state[k].dtype != t.dtype:
                raise ValueError(f"carry leaf {k}: saved {tuple(state[k].shape)} {state[k].dtype}, "
                                 f"this run's {tuple(t.shape)} {t.dtype}")
            t.copy_(state[k])


@dataclass
class VecEnvState:
    """A `VecDeviceEnv`'s state: the batched env state, and each env's
    running episode return (`[N]` f32) and length (`[N]` i32), so reward
    logging costs one pull a rollout."""

    env_state: Any
    ep_return: torch.Tensor
    ep_length: torch.Tensor


class DeviceEnv:
    """Base of the batched envs. A subclass sets `State` (a dataclass of
    tensors), `observation_space` (`spaces.Dict`) and `action_space`, and
    defines `draw_resets`, `observe` and `step` over a batch:

    - `draw_resets(generator, lead)`: fresh reset states `[*lead, ...]`,
      drawn on the generator's device in one go;
    - `observe(state)`: the observation dict of a state;
    - `step(state, actions)`: `(state', obs, reward [N] f32, terminated
      [N] bool, truncated [N] bool)`, deterministic (no env here draws
      inside a step), `obs = observe(state')`.

    No env resets itself: auto-reset is `VecDeviceEnv`'s."""

    State: type
    observation_space: Any
    action_space: Any

    def draw_resets(self, generator: torch.Generator, lead: tuple) -> Any:  # pragma: no cover - interface
        raise NotImplementedError

    def observe(self, state) -> dict:  # pragma: no cover - interface
        raise NotImplementedError

    def step(self, state, actions: torch.Tensor):  # pragma: no cover - interface
        raise NotImplementedError


class VecDeviceEnv:
    """`num_envs` copies of a `DeviceEnv` on `device`, stepped as one batch
    with same-step auto-reset: the batched env the collectors
    (`rollout.py`) step."""

    def __init__(self, env: DeviceEnv, num_envs: int = 1, device: torch.device | str = "cpu"):
        if num_envs <= 0:
            raise ValueError(f"num_envs must be > 0, got {num_envs}")
        self.env = env
        self.num_envs = int(num_envs)
        self.device = torch.device(device)

    def draw_resets(self, generator: torch.Generator, steps: int) -> Any:
        """The fresh states of `steps` steps of every env, `[steps, N, ...]`
        (one draw for a whole rollout; `step` takes one slice)."""
        return self.env.draw_resets(generator, (steps, self.num_envs))

    def reset(self, generator: torch.Generator) -> tuple[VecEnvState, dict]:
        """Every env reset from one draw of `generator` (on this env's
        device), its episode stats zeroed -> (state, obs)."""
        env_state = self.env.draw_resets(generator, (self.num_envs,))
        # tensors of their own: a carry made of these is updated in place
        obs = {k: v.clone() for k, v in self.env.observe(env_state).items()}
        return VecEnvState(
            env_state=env_state,
            ep_return=torch.zeros((self.num_envs,), dtype=torch.float32, device=self.device),
            ep_length=torch.zeros((self.num_envs,), dtype=torch.int32, device=self.device),
        ), obs

    def step(self, state: VecEnvState, actions: torch.Tensor, fresh: Any):
        """One batched step with auto-reset from `fresh` (one step's slice of
        `draw_resets`: the state a finished env restarts in). Returns
        `(state', obs, reward [N] f32, done [N] bool, info)`: `obs` is
        already the reset observation where an env is done; `info` holds
        `final_obs` (the pre-reset observation), `terminated`, `truncated`
        and the episode's `ep_return`/`ep_length` counted through this step
        (valid where done)."""
        stepped, obs, reward, term, trunc = self.env.step(state.env_state, actions)
        done = term | trunc
        ep_return = state.ep_return + reward
        ep_length = state.ep_length + 1
        info = {"final_obs": obs, "terminated": term, "truncated": trunc, "ep_return": ep_return,
                "ep_length": ep_length}
        env_state = tree_select(done, fresh, stepped)
        new = VecEnvState(
            env_state=env_state,
            ep_return=torch.where(done, torch.zeros_like(ep_return), ep_return),
            ep_length=torch.where(done, torch.zeros_like(ep_length), ep_length),
        )
        # the observation of the selected state is the reference's selected
        # observation: each env's obs is a function of its own state alone
        return new, self.env.observe(env_state), reward, done, info

    @property
    def single_observation_space(self):
        return self.env.observation_space

    @property
    def single_action_space(self):
        return self.env.action_space
