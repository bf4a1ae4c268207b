"""Checkpoint save and restore (the port of sheeprl_tpu/utils/checkpoint.py).

The reference writes orbax checkpoints; the card has no orbax, so the port
has its own format, with the reference's layout around it:

  - `<dir>/ckpt_<step>/` holds one `state.pt`, a `torch.save` of host
    copies: the modules', optimizers' and return normalizer's
    `state_dict`s with every tensor on the CPU, counters as ints;
  - the directory is written under a temporary name and renamed into
    place, then finalised by a commit marker (`_CHECKPOINT_COMMITTED`), as
    orbax finalises its own after the rename;
  - `ckpt_<step>.args.json` beside it holds the run's config, so a
    checkpoint rebuilds its model by itself.

A checkpoint is valid when the marker and the sidecar are both there (the
reference's rule, `valid_checkpoint`); `list_checkpoints` and
`latest_checkpoint` skip the others. The state keys follow each
algorithm's key contract (DreamerV3: world_model, actor, critic,
target_critic, the three optimizers, moments, expl_decay_steps,
global_step, batch_size; SAC and DroQ: agent (actor, critics,
target_critics, log_alpha), qf_optimizer, actor_optimizer,
alpha_optimizer, global_step, plus the port's generator; PPO: agent,
optimizer, update_step, plus generator).

Saves block: the reference's asynchronous writer is orbax's. Its
telemetry events, the `ckpt.write` fault-injection site with its retries
and the fallback to an earlier checkpoint when a restore fails
(`next_fallback`) come with `resilience/` (ROADMAP Queue A item 12): here a
save or a load that fails raises.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

__all__ = [
    "COMMIT_MARKER", "STATE_FILE", "latest_checkpoint", "list_checkpoints", "load_checkpoint",
    "load_checkpoint_args", "save_checkpoint", "to_host", "valid_checkpoint",
]

COMMIT_MARKER = "_CHECKPOINT_COMMITTED"
STATE_FILE = "state.pt"


def to_host(tree: Any) -> Any:
    """A copy of `tree` (dicts, lists and tuples of tensors, state_dicts and
    plain values) with every tensor detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: dict[str, Any], args: Any = None) -> int:
    """Write `state` to the checkpoint directory `path` (replacing one that
    is there), then the commit marker, then `<path>.args.json` from `args`
    (a config dataclass with `as_dict`, or a dict). Returns the size of the
    state file in bytes."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(to_host(state), os.path.join(tmp, STATE_FILE))
    size = os.path.getsize(os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        old = f"{path}.old-{os.getpid()}"
        os.replace(path, old)
        shutil.rmtree(old)
    os.replace(tmp, path)
    with open(os.path.join(path, COMMIT_MARKER), "w") as fh:
        fh.write("committed\n")
    if args is not None:
        cfg = args.as_dict() if hasattr(args, "as_dict") else dict(args)
        with open(path + ".args.json", "w") as fh:
            json.dump(cfg, fh)
    return size


def load_checkpoint(path: str, device: str | torch.device = "cpu") -> dict[str, Any]:
    """The state a committed checkpoint holds, its tensors on `device`.
    Raises on a directory without its commit marker (an interrupted or
    partial write) and on a state file that does not load."""
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, COMMIT_MARKER)):
        raise FileNotFoundError(f"{path} is not a committed checkpoint (no {COMMIT_MARKER})")
    return torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)


def load_checkpoint_args(path: str) -> dict[str, Any] | None:
    """The config saved beside a checkpoint (`<path>.args.json`), or None."""
    p = os.path.abspath(path) + ".args.json"
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        return json.load(fh)


def valid_checkpoint(path: str) -> tuple[bool, str]:
    """Structural validity of one checkpoint directory: the commit marker
    (written after the rename) and the args.json sidecar a resumable
    checkpoint needs. -> (ok, reason if not)."""
    if not os.path.isdir(path):
        return False, "not a directory"
    if not os.path.exists(os.path.join(path, COMMIT_MARKER)):
        return False, f"missing commit marker {COMMIT_MARKER}"
    if not os.path.exists(path + ".args.json"):
        return False, "missing args.json sidecar"
    return True, ""


def list_checkpoints(ckpt_dir: str) -> list[str]:
    """Every valid `ckpt_<step>` of a run's checkpoint directory, the
    highest step first; partial or sidecar-less ones are skipped."""
    if not os.path.isdir(ckpt_dir):
        return []
    entries = [e for e in os.listdir(ckpt_dir) if e.startswith("ckpt_") and e.split("_")[-1].isdigit()]
    entries.sort(key=lambda e: int(e.split("_")[-1]), reverse=True)
    return [p for p in (os.path.join(ckpt_dir, e) for e in entries) if valid_checkpoint(p)[0]]


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The newest valid `ckpt_<step>` of a run's checkpoint directory
    (`list_checkpoints`), or None."""
    found = list_checkpoints(ckpt_dir)
    return found[0] if found else None
