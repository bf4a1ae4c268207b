"""Vector envs, synchronous and in subprocesses (the port of
sheeprl_tpu/envs/vector.py), with the reference's semantics:

  - **same-step autoreset**: when an env's episode ends, its final
    observation is `infos[i]["final_observation"]` and the returned
    observation is already the reset one;
  - **dict-obs batching**: observations come back as `{key: [N, ...]}`
    numpy stacks;
  - **per-env info dicts**: `infos` is a list of `num_envs` dicts (the
    episode statistics of `RecordEpisodeStatistics` pass through).

`AsyncVectorEnv` keeps one spawned process per env. An env thunk is sent
to its worker with pickle, so it must be a picklable callable (the
`utils/env.py` thunks are); a worker imports only the env's own modules
and never touches CUDA. An exception in a worker is raised in the parent
with the worker's traceback, and a worker that dies raises there too:
nothing is restarted. `close()` joins every worker.
"""

from __future__ import annotations

import multiprocessing as mp
import traceback
from typing import Any, Callable, Sequence

import numpy as np

from . import spaces

__all__ = ["AsyncVectorEnv", "SyncVectorEnv", "make_vector_env"]

_POLL_S = 1.0  # how often a waiting parent looks whether the worker still lives
_CLOSE_S = 5.0  # how long `close` waits for a worker's answer, then for its exit


def _batch_obs(space, obs_list: Sequence[Any]):
    if isinstance(space, spaces.Dict):
        return {k: np.stack([o[k] for o in obs_list]) for k in space.spaces}
    return np.stack(obs_list)


def _seeds(seed, n: int) -> list:
    if seed is None or isinstance(seed, int):
        return [seed if seed is None else seed + i for i in range(n)]
    return list(seed)


def _step_autoreset(env, action):
    obs, reward, term, trunc, info = env.step(action)
    if term or trunc:
        info = dict(info)
        info["final_observation"] = obs
        obs, _ = env.reset()
    return obs, reward, term, trunc, info


def _stack_steps(space, results):
    obs_list, rewards, terms, truncs, infos = zip(*results)
    return (
        _batch_obs(space, obs_list),
        np.asarray(rewards, dtype=np.float32),
        np.asarray(terms, dtype=bool),
        np.asarray(truncs, dtype=bool),
        list(infos),
    )


class _VectorEnvBase:
    single_observation_space: Any
    single_action_space: Any
    num_envs: int

    @property
    def observation_space(self):
        return self.single_observation_space

    @property
    def action_space(self):
        return self.single_action_space


class SyncVectorEnv(_VectorEnvBase):
    """The envs stepped one after another in this process."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.single_observation_space = self.envs[0].observation_space
        self.single_action_space = self.envs[0].action_space

    def reset(self, seed: int | Sequence[int] | None = None):
        obs_list, infos = [], []
        for env, s in zip(self.envs, _seeds(seed, self.num_envs)):
            obs, info = env.reset(seed=s)
            obs_list.append(obs)
            infos.append(info)
        return _batch_obs(self.single_observation_space, obs_list), infos

    def step(self, actions: Sequence[Any]):
        return _stack_steps(self.single_observation_space,
                            [_step_autoreset(env, a) for env, a in zip(self.envs, actions)])

    def close(self):
        for env in self.envs:
            env.close()


def _worker(remote, parent_remote, env_fn) -> None:
    parent_remote.close()
    try:
        env = env_fn()
    except Exception:  # the parent raises it with this traceback
        remote.send(("error", traceback.format_exc()))
        remote.close()
        return
    try:
        while True:
            cmd, payload = remote.recv()
            try:
                if cmd == "reset":
                    out = env.reset(seed=payload)
                elif cmd == "step":
                    out = _step_autoreset(env, payload)
                elif cmd == "spaces":
                    out = (env.observation_space, env.action_space)
                elif cmd == "close":
                    env.close()
                    remote.send(("ok", None))
                    break
                else:
                    raise ValueError(f"unknown command {cmd!r}")
            except Exception:  # the parent raises it with this traceback
                remote.send(("error", traceback.format_exc()))
                continue
            remote.send(("ok", out))
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass
    finally:
        remote.close()


class AsyncVectorEnv(_VectorEnvBase):
    """One spawned worker process per env, each stepping its env on
    command. Driver scripts guard their entry point with `if __name__ ==
    "__main__":`, as any use of `spawn` needs."""

    def __init__(self, env_fns: Sequence[Callable[[], Any]]):
        ctx = mp.get_context("spawn")
        self.num_envs = len(env_fns)
        self._closed = False
        self._remotes, self._procs = [], []
        for fn in env_fns:
            remote, work_remote = ctx.Pipe(duplex=True)
            proc = ctx.Process(target=_worker, args=(work_remote, remote, fn), daemon=True)
            proc.start()
            work_remote.close()
            self._remotes.append(remote)
            self._procs.append(proc)
        try:
            self.single_observation_space, self.single_action_space = self._ask(0, "spaces", None)
        except BaseException:
            self.close()
            raise

    @property
    def processes(self) -> list:
        """The worker processes, one an env."""
        return list(self._procs)

    def _recv(self, i: int):
        remote, proc = self._remotes[i], self._procs[i]
        while not remote.poll(_POLL_S):
            if not proc.is_alive():
                raise RuntimeError(f"vector env worker {i} (pid {proc.pid}) died with exit code {proc.exitcode}")
        try:
            status, out = remote.recv()
        except EOFError as err:
            proc.join(_POLL_S)
            raise RuntimeError(f"vector env worker {i} (pid {proc.pid}) closed its pipe "
                               f"(exit code {proc.exitcode})") from err
        if status == "error":
            raise RuntimeError(f"vector env worker {i} raised:\n{out}")
        return out

    def _send(self, i: int, cmd: str, payload) -> None:
        try:
            self._remotes[i].send((cmd, payload))
        except (BrokenPipeError, OSError):
            pass  # a worker that is gone: `_recv` reports what it left or how it ended

    def _ask(self, i: int, cmd: str, payload):
        self._send(i, cmd, payload)
        return self._recv(i)

    def _ask_all(self, cmd: str, payloads: Sequence[Any]) -> list:
        if self._closed:
            raise RuntimeError("the vector env is closed")
        for i, p in enumerate(payloads):
            self._send(i, cmd, p)
        return [self._recv(i) for i in range(self.num_envs)]

    def reset(self, seed: int | Sequence[int] | None = None):
        obs_list, infos = zip(*self._ask_all("reset", _seeds(seed, self.num_envs)))
        return _batch_obs(self.single_observation_space, obs_list), list(infos)

    def step(self, actions: Sequence[Any]):
        return _stack_steps(self.single_observation_space, self._ask_all("step", list(actions)))

    def close(self):
        if self._closed:
            return
        self._closed = True
        for remote, proc in zip(self._remotes, self._procs):
            if proc.is_alive():
                try:
                    remote.send(("close", None))
                    if remote.poll(_CLOSE_S):
                        remote.recv()
                except (BrokenPipeError, EOFError, OSError):
                    pass  # a worker that is gone is joined below
        for remote, proc in zip(self._remotes, self._procs):
            proc.join(_CLOSE_S)
            if proc.is_alive():
                proc.terminate()
                proc.join(_CLOSE_S)
            remote.close()


def make_vector_env(env_fns: Sequence[Callable[[], Any]], sync: bool = True) -> _VectorEnvBase:
    return SyncVectorEnv(env_fns) if sync else AsyncVectorEnv(env_fns)
