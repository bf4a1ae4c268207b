"""Per-algo serving adapters (the port of sheeprl_tpu/serve/policies.py):
build the served params from a checkpoint (`--ckpt`, the port's format of
`utils/checkpoint.py`) or a fresh `--model_argv` init, expose the policy
step, and map batched rows to per-request results.

With `--ckpt` the model's config comes from the checkpoint's args.json
sidecar and replaces `--model_argv`; the loader that builds the params
from a checkpoint is also the ParamsStore's reload callback, so a client
RELOAD moves the server to another checkpoint of the same config.

  - `sac` (`SACServePolicy`, `_build_sac`): the stateless greedy actor, obs
    [B, obs_dim] -> actions [B, act_dim] through
    `SACActor.get_greedy_actions` (tanh of the mean, no sampling), so a
    served action equals a direct call on the same params;
  - `dreamer_v3` (`DV3ServePolicy`, `_build_dv3`): the player steps in
    greedy mode (`PlayerDV3.step`: a discrete actor's mode, a continuous
    actor's likeliest of 100 samples, zero exploration; the answer is the
    one-hot or float action row). Its recurrent PlayerState
    lives SERVER-side in a per-session table on the device: a request
    carries a `session` id (plus an optional `reset` flag), the adapter
    gathers the session's state row into the batch, steps, and scatters the
    updated row back. Requests are single-row.

The DreamerV3 posterior is still a sample, as in the reference's served
step, and so are a continuous actor's 100 candidates. The reference draws
them with a constant key, so a row's draw depends on its place in the
batch; the port instead draws one Gumbel noise row, and for a continuous
actor one [100, A] set of uniforms, from `--seed` when the server starts
and gives them to every row, so a served answer depends only on (params,
session state, obs) and equals a direct `PlayerDV3.step` with that noise.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from .errors import ServeError

__all__ = ["DV3ServePolicy", "SACServePolicy", "build_policy"]


def build_policy(args, device: torch.device):
    """-> (policy, params, loader). `loader(path)` re-extracts the served
    params from a checkpoint — the ParamsStore reload callback. A
    checkpoint that does not load raises here, before the server listens."""
    if args.algo == "sac":
        return _build_sac(args, device)
    if args.algo == "dreamer_v3":
        return _build_dv3(args, device)
    raise ServeError(f"unservable algo {args.algo!r}")


def _training_args(args, args_cls):
    """The training config the model is rebuilt from: the checkpoint's
    args.json when serving a checkpoint (the widths and keys must match the
    saved weights), else `--model_argv` (reference policies.py:46-60)."""
    from ..utils.checkpoint import load_checkpoint_args
    from ..utils.parser import DataclassArgumentParser

    parser = DataclassArgumentParser(args_cls)
    if args.ckpt:
        saved = load_checkpoint_args(args.ckpt)
        if not saved:
            raise ServeError(f"checkpoint {args.ckpt} has no args.json sidecar: cannot rebuild the model it holds")
        # never a training resume, never a run directory of the training run
        saved = dict(saved, checkpoint_path=None, root_dir=None, run_name=None)
        (targs,) = parser.parse_dict(saved)
    else:
        (targs,) = parser.parse_args_into_dataclasses((args.model_argv or "").split())
    return targs


# ---------------------------------------------------------------------------
# SAC
# ---------------------------------------------------------------------------


class SACServePolicy:
    algo = "sac"
    max_rows_per_request = None  # any row count up to the largest rung

    def __init__(self, obs_dim: int, act_dim: int, device: torch.device):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.device = device
        self._obs: dict[int, torch.Tensor] = {}  # the rung's observation buffer

    @staticmethod
    def step(actor, obs: torch.Tensor) -> torch.Tensor:
        return actor.get_greedy_actions(obs)

    def obs_buffer(self, rung: int) -> torch.Tensor:
        """The rung's observation buffer on the device: a rung's graph
        reads it in place (`CompilePlan.register(adopt=True)`)."""
        if rung not in self._obs:
            self._obs[rung] = torch.zeros((rung, self.obs_dim), device=self.device)
        return self._obs[rung]

    def example(self, params, rung: int) -> tuple:
        return params, self.obs_buffer(rung)

    def run(self, runner: Callable, params, version, batch, pendings, rung) -> dict:
        del version, pendings
        with torch.inference_mode():
            obs = self.obs_buffer(rung)
            obs.copy_(torch.from_numpy(np.asarray(batch["obs"], dtype=np.float32)))
            acts = runner(params, obs)
            return {"actions": acts.float().cpu().numpy()}


def _build_sac(args, device: torch.device):
    from ..algos.sac.agent import SACActor
    from ..algos.sac.args import SACArgs
    from ..envs import spaces
    from ..utils.env import make_env

    from ..utils.checkpoint import load_checkpoint

    targs = _training_args(args, SACArgs)
    # one probe env to read the spaces, then close; serving never steps an env
    env = make_env(targs.env_id, targs.seed)()
    try:
        if not isinstance(env.action_space, spaces.Box):
            raise ServeError("sac serving needs a continuous action space")
        obs_dim = int(np.prod(env.observation_space.shape))
        act_dim = int(np.prod(env.action_space.shape))
        action_low, action_high = env.action_space.low, env.action_space.high
    finally:
        env.close()
    actor = SACActor(
        obs_dim, act_dim, hidden_size=targs.actor_hidden_size, action_low=action_low,
        action_high=action_high, precision=targs.precision,
        generator=torch.Generator().manual_seed(targs.seed),
    ).to(device).eval()

    def loader(path: str):
        """A new actor holding the checkpoint's `agent.actor` (reference
        policies.py:142-143)."""
        fresh = copy.deepcopy(actor)
        fresh.load_state_dict(load_checkpoint(path, device)["agent"]["actor"])
        return fresh.eval()

    params = loader(args.ckpt) if args.ckpt else actor
    return SACServePolicy(obs_dim, act_dim, device), params, loader


# ---------------------------------------------------------------------------
# DreamerV3
# ---------------------------------------------------------------------------


class DV3ServePolicy:
    algo = "dreamer_v3"
    max_rows_per_request = 1  # one session, one env, one row
    session_cap = 1024  # sessions kept; the oldest is evicted first

    def __init__(self, obs_space: dict, cnn_keys, mlp_keys, device: torch.device,
                 gumbel: torch.Tensor, uniforms: torch.Tensor | None = None):
        from ..algos.dreamer_v3.utils import make_device_preprocess

        self.obs_space = obs_space
        self.obs_keys = [*cnn_keys, *mlp_keys]
        self.device = device
        self.gumbel = gumbel  # [S, D], shared by every row
        self.uniforms = uniforms  # [BEST_OF, A] for a continuous actor, shared by every row
        self._sessions: dict[str, dict[str, torch.Tensor]] = {}
        self._init_cache: tuple[int, dict[str, torch.Tensor]] | None = None
        self._prep = make_device_preprocess(cnn_keys)
        self._buffers: dict[int, tuple[dict, dict]] = {}  # rung -> (state, obs) on the device

    def step(self, player, state: dict, obs: dict) -> tuple[dict, torch.Tensor]:
        """One greedy player step over a batch of state rows and raw obs."""
        from ..algos.dreamer_v3.agent import PlayerState

        st = PlayerState(
            actions=state["actions"],
            recurrent_state=state["recurrent"],
            stochastic_state=state["stochastic"],
        )
        rows = st.recurrent_state.shape[0]
        uniforms = None if self.uniforms is None else self.uniforms[:, None].expand(-1, rows, -1)
        new_st, acts = player.step(st, self._prep(obs), gumbel=self.gumbel.expand(rows, -1, -1), uniforms=uniforms)
        return {
            "actions": new_st.actions,
            "recurrent": new_st.recurrent_state,
            "stochastic": new_st.stochastic_state,
        }, acts

    def buffers(self, rung: int, params) -> tuple[dict, dict]:
        """The rung's state and observation buffers on the device: a rung's
        graph reads them in place (`CompilePlan.register(adopt=True)`)."""
        from ..utils.env import obs_zeros

        if rung not in self._buffers:
            with torch.no_grad():
                st = params.init_states(rung)
            state = {"actions": st.actions, "recurrent": st.recurrent_state, "stochastic": st.stochastic_state}
            obs = obs_zeros(self.obs_space, self.obs_keys, (rung,), self.device)
            self._buffers[rung] = (state, obs)
        return self._buffers[rung]

    def example(self, params, rung: int) -> tuple:
        return (params, *self.buffers(rung, params))

    # ---- state rows --------------------------------------------------------
    def init_row(self, version: int, params) -> dict[str, torch.Tensor]:
        """A fresh single-row PlayerState, cached per params version (the
        transition prior depends on the weights)."""
        if self._init_cache is not None and self._init_cache[0] == version:
            return self._init_cache[1]
        with torch.inference_mode():
            st = params.init_states(1)
        row = {"actions": st.actions[0], "recurrent": st.recurrent_state[0],
               "stochastic": st.stochastic_state[0]}
        self._init_cache = (version, row)
        return row

    def run(self, runner: Callable, params, version, batch, pendings, rung) -> dict:
        init = self.init_row(version, params)
        rows = []
        sids: list[str | None] = []
        for p in pendings:
            sid = p.meta.get("session")
            reset = bool(p.meta.get("reset"))
            if sid is not None and not reset and sid in self._sessions:
                rows.append(self._sessions[sid])
            else:
                rows.append(init)
            sids.append(sid)
        while len(rows) < rung:  # pad rows carry the inert init state
            rows.append(init)
        with torch.inference_mode():
            state, obs = self.buffers(rung, params)
            for k, buf in state.items():
                torch.stack([r[k] for r in rows], out=buf)
            for k, buf in obs.items():
                buf.copy_(torch.from_numpy(np.asarray(batch[k])))
            new_state, acts = runner(params, state, obs)
            actions = acts.float().cpu().numpy()
            # on the card the runner's outputs are a graph's static outputs,
            # overwritten by the next dispatch: the session rows are views of
            # a copy
            kept = {k: v.clone() for k, v in new_state.items()}
        # scatter updated rows back; only the dispatch thread touches the
        # table, so plain dict ops are race-free
        for i, sid in enumerate(sids):
            if sid is not None:
                self._sessions[sid] = {k: v[i] for k, v in kept.items()}
        while len(self._sessions) > self.session_cap:  # FIFO eviction
            self._sessions.pop(next(iter(self._sessions)))
        return {"actions": actions}


def _build_dv3(args, device: torch.device):
    from ..algos.dreamer_v3.agent import BEST_OF, PlayerDV3, build_models
    from ..algos.dreamer_v3.args import DreamerV3Args
    from ..algos.ppo.ppo import actions_dim_of, validate_obs_keys
    from ..ops.distributions import gumbel_noise
    from ..utils.checkpoint import load_checkpoint
    from ..utils.env import make_dict_env

    targs = _training_args(args, DreamerV3Args)
    # one probe env to read the spaces, then close; serving never steps an env
    probe = make_dict_env(targs.env_id, targs.seed, rank=0, args=targs)()
    observation_space = probe.observation_space
    action_space = probe.action_space
    probe.close()
    cnn_keys, mlp_keys = validate_obs_keys(observation_space, targs)
    actions_dim, is_continuous = actions_dim_of(action_space)

    generator = torch.Generator().manual_seed(targs.seed)
    world_model, actor, _, _ = build_models(
        generator, actions_dim, is_continuous, targs, observation_space.spaces, cnn_keys, mlp_keys
    )
    player = PlayerDV3(
        world_model.encoder, world_model.rssm, actor, actions_dim=actions_dim,
        stochastic_size=targs.stochastic_size, discrete_size=targs.discrete_size,
        recurrent_state_size=targs.recurrent_state_size, is_continuous=is_continuous,
        compute_dtype=targs.precision,
    ).to(device).eval()
    gumbel = gumbel_noise((targs.stochastic_size, targs.discrete_size), generator).to(device)
    uniforms = None
    if is_continuous:  # drawn after the posterior's noise, so a discrete model's stream is unchanged
        uniforms = torch.rand((BEST_OF, int(sum(actions_dim))), generator=generator).to(device)

    def loader(path: str) -> PlayerDV3:
        """A new player from the checkpoint's `world_model` (its encoder and
        RSSM) and `actor` (reference policies.py:325-327)."""
        ckpt = load_checkpoint(path, device)
        fresh = copy.deepcopy(player)
        for part in ("encoder", "rssm"):
            prefix = part + "."
            getattr(fresh, part).load_state_dict(
                {k[len(prefix):]: v for k, v in ckpt["world_model"].items() if k.startswith(prefix)})
        fresh.actor.load_state_dict(ckpt["actor"])
        return fresh.eval()

    params = loader(args.ckpt) if args.ckpt else player
    policy = DV3ServePolicy(observation_space.spaces, cnn_keys, mlp_keys, device, gumbel, uniforms)
    return policy, params, loader
