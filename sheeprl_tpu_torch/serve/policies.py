"""Serving adapter for the DreamerV3 player (the port of
sheeprl_tpu/serve/policies.py's `DV3ServePolicy` and `_build_dv3`).

The player steps in greedy mode (mode actions, zero exploration). Its
recurrent PlayerState lives SERVER-side in a per-session table on the
device: a request carries a `session` id (plus an optional `reset` flag),
the adapter gathers the session's state row into the batch, steps, and
scatters the updated row back. Requests are single-row.

The posterior is still a sample, as in the reference's served step. The
reference draws it with a constant key, so a row's draw depends on its
place in the batch; the port instead draws one Gumbel noise row from
`--seed` when the server starts and gives it to every row, so a served
answer depends only on (params, session state, obs) and equals a direct
`PlayerDV3.step` with that noise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .errors import ServeError

__all__ = ["DV3ServePolicy", "build_policy"]


def build_policy(args, device: torch.device):
    """-> (policy, params, loader). `loader(path)` re-extracts the served
    params from a checkpoint — the ParamsStore reload callback."""
    if args.ckpt:
        raise NotImplementedError(
            "--ckpt is not yet ported (reading the reference's orbax checkpoints "
            "needs orbax); serve a fresh init from --model_argv"
        )
    if args.algo == "dreamer_v3":
        return _build_dv3(args, device)
    raise ServeError(f"unservable algo {args.algo!r}")


class DV3ServePolicy:
    algo = "dreamer_v3"
    max_rows_per_request = 1  # one session, one env, one row
    session_cap = 1024  # sessions kept; the oldest is evicted first

    def __init__(self, obs_space: dict, cnn_keys, mlp_keys, device: torch.device,
                 gumbel: torch.Tensor):
        from ..algos.dreamer_v3.utils import make_device_preprocess

        self.obs_space = obs_space
        self.obs_keys = [*cnn_keys, *mlp_keys]
        self.device = device
        self.gumbel = gumbel  # [S, D], shared by every row
        self._sessions: dict[str, dict[str, torch.Tensor]] = {}
        self._init_cache: tuple[int, dict[str, torch.Tensor]] | None = None
        self._prep = make_device_preprocess(cnn_keys)

    def step(self, player, state: dict, obs: dict) -> tuple[dict, torch.Tensor]:
        """One greedy player step over a batch of state rows and raw obs."""
        from ..algos.dreamer_v3.agent import PlayerState

        st = PlayerState(
            actions=state["actions"],
            recurrent_state=state["recurrent"],
            stochastic_state=state["stochastic"],
        )
        rows = st.recurrent_state.shape[0]
        new_st, acts = player.step(
            st, self._prep(obs), gumbel=self.gumbel.expand(rows, -1, -1),
            expl_amount=0.0, is_training=False,
        )
        return {
            "actions": new_st.actions,
            "recurrent": new_st.recurrent_state,
            "stochastic": new_st.stochastic_state,
        }, acts

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
            state = {k: torch.stack([r[k] for r in rows]) for k in ("actions", "recurrent", "stochastic")}
            obs = {k: torch.from_numpy(np.asarray(batch[k])).to(self.device) for k in self.obs_keys}
            new_state, acts = runner(params, state, obs)
            actions = acts.float().cpu().numpy()
        # scatter updated rows back; only the dispatch thread touches the
        # table, so plain dict ops are race-free
        for i, sid in enumerate(sids):
            if sid is not None:
                self._sessions[sid] = {k: v[i] for k, v in new_state.items()}
        while len(self._sessions) > self.session_cap:  # FIFO eviction
            self._sessions.pop(next(iter(self._sessions)))
        return {"actions": actions}


def _build_dv3(args, device: torch.device):
    from ..algos.dreamer_v3.agent import PlayerDV3, build_models
    from ..algos.dreamer_v3.args import DreamerV3Args
    from ..algos.ppo.ppo import actions_dim_of, validate_obs_keys
    from ..ops.distributions import gumbel_noise
    from ..utils.env import make_dict_env
    from ..utils.parser import DataclassArgumentParser

    (targs,) = DataclassArgumentParser(DreamerV3Args).parse_args_into_dataclasses(
        (args.model_argv or "").split()
    )
    # one probe env to read the spaces, then close; serving never steps an env
    probe = make_dict_env(targs.env_id, targs.seed, rank=0, args=targs)()
    observation_space = probe.observation_space
    action_space = probe.action_space
    probe.close()
    cnn_keys, mlp_keys = validate_obs_keys(observation_space, targs)
    actions_dim, is_continuous = actions_dim_of(action_space)

    generator = torch.Generator().manual_seed(targs.seed)
    encoder, rssm, actor = build_models(
        generator, actions_dim, is_continuous, targs, observation_space.spaces, cnn_keys, mlp_keys
    )
    player = PlayerDV3(
        encoder, rssm, actor, actions_dim=actions_dim,
        stochastic_size=targs.stochastic_size, discrete_size=targs.discrete_size,
        recurrent_state_size=targs.recurrent_state_size, is_continuous=is_continuous,
        compute_dtype=targs.precision,
    ).to(device).eval()
    gumbel = gumbel_noise((targs.stochastic_size, targs.discrete_size), generator).to(device)

    def loader(path: str):
        raise NotImplementedError(f"cannot reload {path}: checkpoint reading is not yet ported")

    policy = DV3ServePolicy(observation_space.spaces, cnn_keys, mlp_keys, device, gumbel)
    return policy, player, loader
