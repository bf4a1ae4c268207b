"""Rematerialization of a scan body (the port of sheeprl_tpu/ops/scan.py's
`checkpoint_body`; its unroll knob and autotuner have no counterpart: the
port's scans are Python loops, each step a few kernels inside the train
step's CUDA graph).

`checkpoint_body(step, remat)` is the one place a recurrent step is
wrapped for `--remat`, shared by the RSSM's dynamic-learning loop and the
imagination step. The mode is `compile/decisions.py:remat_mode`'s:

  - "on": `torch.utils.checkpoint` of the whole step (non-reentrant):
    autograd keeps only the step's inputs and recomputes its forward when
    the backward first needs one of its saved tensors;
  - "policy": selective checkpointing, the reference's
    `dots_with_no_batch_dims_saveable`: the outputs of the matrix products
    without batch dimensions (`aten.mm`, `aten.addmm`) are kept, everything
    else is recomputed. A hand kernel's output is recomputed, as the
    reference recomputes a `pallas_call`: the LayerNorm-GRU's residual
    forward (kernel 2) launches again in the backward;
  - anything else: `step` unchanged.

The recomputation replays the same operations on the same inputs, so the
gradients are bit for bit those without it. The steps draw no random
numbers (their draws are passed in), so no RNG state is saved, which also
keeps a checkpointed step capturable in a CUDA graph.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from ..compile.decisions import remat_mode

__all__ = ["SAVED_OPS", "checkpoint_body"]

# the products whose outputs "policy" keeps
SAVED_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in SAVED_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_body(step: Callable, remat: Any) -> Callable:
    mode = remat_mode(remat)
    if mode == "off":
        return step
    kwargs: dict = dict(use_reentrant=False, preserve_rng_state=False)
    if mode == "policy":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_saveable)

    @functools.wraps(step)
    def body(*args, **step_kwargs):
        return checkpoint(step, *args, **kwargs, **step_kwargs)

    return body
