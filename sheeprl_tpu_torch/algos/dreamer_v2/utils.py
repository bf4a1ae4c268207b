"""Dreamer-family helpers (the port of sheeprl_tpu/algos/dreamer_v2/utils.py,
`maybe_decide_remat` so far; the rest comes with DreamerV2, ROADMAP Queue A
item 6)."""

from __future__ import annotations

import torch

from ...compile.decisions import REPEATS, Decision, decide_remat
from ...ops.distributions import gumbel_noise
from ...ops.precision import compute_dtype

__all__ = ["maybe_decide_remat"]


def _rssm_probe_example(world_model, args, act_dim: int, device) -> tuple:
    """The RSSM dynamic scan's arguments at this run's shapes: (world
    model, posterior0 [B, S, D], recurrent0 [B, R], actions [T, B, A],
    embedded [T, B, E], is_first [T, B, 1], Gumbels [T, B, S, D], seeded
    by `args.seed`)."""
    T, B = int(args.per_rank_sequence_length), int(args.per_rank_batch_size)
    dt = compute_dtype(args.precision)
    S, D = args.stochastic_size, args.discrete_size
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return (
        world_model,
        torch.zeros((B, S, D), dtype=dt, device=device),
        torch.zeros((B, args.recurrent_state_size), dtype=dt, device=device),
        torch.zeros((T, B, int(act_dim)), dtype=dt, device=device),
        torch.zeros((T, B, world_model.encoder.output_dim), dtype=dt, device=device),
        torch.zeros((T, B, 1), device=device),
        gumbel_noise((T, B, S, D), gen, device),
    )


def _probe(mode: str):
    """The gradient of the RSSM dynamic scan's outputs' squared sum with
    respect to the RSSM's parameters, the scan body checkpointed per
    `mode`: (the loss, the gradients)."""

    def grad_loss(wm, post0, rec0, actions, embedded, is_first, gumbels):
        with torch.inference_mode(False), torch.enable_grad():
            outs = wm.rssm.scan_dynamic(post0, rec0, actions, embedded, is_first, gumbels, remat=mode)
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
