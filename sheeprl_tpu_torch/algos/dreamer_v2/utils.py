"""Dreamer-family helpers (the port of sheeprl_tpu/algos/dreamer_v2/utils.py):
`preprocess_obs` and `make_device_preprocess` in the V1/V2 image convention
([-0.5, 0.5]), `test`, the evaluation episode of DreamerV1 and V2, and
`maybe_decide_remat`, which every Dreamer runs for `--remat auto`. The
reference's step-blob codec (`make_row_codec`, `make_blob_row`,
`substitute_step_obs`) comes with `data/blob.py`, and its scan-unroll
autotuner with `ops/scan.py`'s unroll knob (ROADMAP Queue A item 5)."""

from __future__ import annotations

import inspect

import numpy as np
import torch

from ...compile.decisions import REPEATS, Decision, decide_remat
from ...ops.distributions import gumbel_noise
from ...ops.precision import compute_dtype

__all__ = ["make_device_preprocess", "maybe_decide_remat", "preprocess_obs", "test"]

# V1 and V2 scale images into [-0.5, 0.5]
IMAGE_OFFSET = 0.5


def preprocess_obs(obs: dict, cnn_keys, mlp_keys) -> dict:
    """Host batch -> float32 arrays: images scaled into [-0.5, 0.5], vectors
    as they are."""
    out = {k: np.asarray(obs[k], dtype=np.float32) / 255.0 - IMAGE_OFFSET for k in cnn_keys}
    out.update({k: np.asarray(obs[k], dtype=np.float32) for k in mlp_keys})
    return out


def make_device_preprocess(cnn_keys):
    """`preprocess_obs` on the device: raw obs (uint8 pixels) in, float32
    out where the step runs (`algos/dreamer_v3/utils.py`'s, offset 0.5)."""
    from ..dreamer_v3.utils import make_device_preprocess as _make

    return _make(cnn_keys, offset=IMAGE_OFFSET)


def test(player, logger, args, cnn_keys, sample_actions: bool = False) -> tuple[float, int]:
    """One evaluation episode of a DreamerV1 or V2 player in a fresh env
    reset with `args.seed` (`algos/dreamer_v3/utils.py:test` with the V1/V2
    image offset): the greedy step unless `sample_actions`.
    -> (the episode's return, its player steps)."""
    from ..dreamer_v3.utils import test as _test

    return _test(player, logger, args, cnn_keys, sample_actions=sample_actions, offset=IMAGE_OFFSET)


def _rssm_probe_example(world_model, args, act_dim: int, device) -> tuple:
    """The RSSM dynamic scan's arguments at this run's shapes: (world
    model, posterior0 [B, S, D], recurrent0 [B, R], actions [T, B, A],
    embedded [T, B, E], is_first [T, B, 1], Gumbels [T, B, S, D], seeded
    by `args.seed`); for DreamerV1's Gaussian RSSM, which takes no
    `is_first`, (world model, posterior0 [B, S], recurrent0, actions,
    embedded, normals [T, B, S])."""
    T, B = int(args.per_rank_sequence_length), int(args.per_rank_batch_size)
    dt = compute_dtype(args.precision)
    S = args.stochastic_size
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rec0 = torch.zeros((B, args.recurrent_state_size), dtype=dt, device=device)
    actions = torch.zeros((T, B, int(act_dim)), dtype=dt, device=device)
    embedded = torch.zeros((T, B, world_model.encoder.output_dim), dtype=dt, device=device)
    if "is_first" not in inspect.signature(world_model.rssm.scan_dynamic).parameters:
        # DreamerV1's Gaussian RSSM: no resets, normal draws
        return (world_model, torch.zeros((B, S), dtype=dt, device=device), rec0, actions, embedded,
                torch.randn((T, B, S), generator=gen, device=device))
    D = args.discrete_size
    return (world_model, torch.zeros((B, S, D), dtype=dt, device=device), rec0, actions, embedded,
            torch.zeros((T, B, 1), device=device), gumbel_noise((T, B, S, D), gen, device))


def _probe(mode: str):
    """The gradient of the RSSM dynamic scan's outputs' squared sum with
    respect to the RSSM's parameters, the scan body checkpointed per
    `mode`: (the loss, the gradients)."""

    def grad_loss(wm, *inputs):
        with torch.inference_mode(False), torch.enable_grad():
            outs = wm.rssm.scan_dynamic(*inputs, remat=mode)
            loss = sum((o.float() ** 2).sum() for o in outs)
            params = [p for p in wm.rssm.parameters() if p.requires_grad]
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        return loss.detach(), [g for g in grads if g is not None]

    return grad_loss


def maybe_decide_remat(algo: str, world_model, args, act_dim: int, telem=None,
                       store_path: str | None = None, repeats: int = REPEATS) -> Decision | None:
    """`--remat auto`: settle the mode by measurement before the first
    gradient step, and write the winner into `args.remat`, which every
    step reads. The probe is the gradient of the RSSM dynamic scan at this
    run's shapes; the ladder (off, policy, on) runs through
    `compile/decisions.py:decide_remat` (strictly fewer peak bytes at most
    5 % slower, bit-exact gradients). The reference first reads its
    committed memory ledger and resolves to off without a probe when the
    step keeps nothing across the scan; the port has no ledger yet
    (ROADMAP Queue A item 10) and always probes. `repeats` timed calls a
    candidate (the median). Any other `--remat` returns None."""
    if str(args.remat).strip().lower() != "auto":
        return None
    device = next(world_model.parameters()).device
    example = _rssm_probe_example(world_model, args, act_dim, device)
    T, B = int(args.per_rank_sequence_length), int(args.per_rank_batch_size)
    decision = decide_remat(f"{algo}.rssm_dynamic_grad[T={T},B={B},R={args.recurrent_state_size}]", _probe,
                            example, repeats=repeats, store_path=store_path)
    args.remat = decision.winner
    if telem is not None:
        telem.event("sheepopt", family="remat", probe=decision.name, winner=decision.winner,
                    accepted=decision.accepted, source=decision.source, candidates=decision.candidates)
    return decision
