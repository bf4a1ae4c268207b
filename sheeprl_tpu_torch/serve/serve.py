"""`sheeprl_tpu_torch serve` — the batched policy-inference serving tier (the
port of sheeprl_tpu/serve/serve.py).

Wiring, in dependency order:

  1. build the policy from `--ckpt` (a checkpoint of the port's training,
     its config from the args.json sidecar) or a fresh `--model_argv` init
     on `--device` (policies.py; the CUDA device unless `--device cpu`, and
     raising when CUDA is missing);
  2. size the batch ladder: each `--ladder` rung's peak bytes measured by
     one eager call and memoized in `serve_ladder.json`, kept or refused
     against the serving memory budget (ladder.py), one `serve.ladder`
     event a rung;
  3. `--quant int8` (sac, dreamer_v3): calibrate and quantize, then accept
     each rung as int8 or f32 by timing under the divergence receipt
     (quant.py); SAC's int8 rungs dispatch the quantized twin through the
     fused trunk kernel, DreamerV3's through the player step; a hot reload
     re-derives the twin in the reload thread;
  4. hot-reloadable params (params.py: a client RELOAD, or with
     `--reload_poll_s` a newer valid checkpoint in `--ckpt`'s directory,
     loads another checkpoint off the dispatch path and flips to it; a
     reload that fails keeps the version and counts
     `Serve/reload_failures`), micro-batcher (batcher.py), FLK1 socket
     front (server.py: request spans, PROFILE frames); SIGUSR2 opens an
     on-demand profiler window too (`telemetry/trace.py`);
  5. the per-rung steps registered with the CompilePlan as `policy_b<rung>`
     (compile/plan.py): on the card each dispatch is one CUDA graph replay,
     captured at startup (`--warm_compile on`, the default) or at the
     rung's first dispatch. A graph holds its parameters by address, so the
     dispatch thread copies a reloaded version's tensors into the held ones
     before the replay (params.py:`GraphParams`);
  6. the serve loop: `Serve/*` telemetry intervals, the occupancy re-tier
     (every 16 loop steps, when 16 more dispatches came: a rung at the rows
     the dispatches carry, sized as at startup, at most 2 added, each a
     `serve.retier` event; a broken probe is a `serve.retier_error` event),
     and graceful drain on SIGTERM/SIGINT — queued requests are served, NEW
     requests are shed with reason="draining", and the process exits rc 75.
     `--serve_requests` completion stays a plain rc 0.

A re-tiered rung is registered on the same plan and so is a graph too,
captured at its first dispatch on the dispatch thread. Its capture, the
re-tier's probe and every reload (the checkpoint load and the int8 twin's
re-derivation) hold one lock, so no capture ever runs beside another
thread's work on the card (the plan also captures in `thread_local` mode).

The resolved listen address is printed AND written to
`<log_dir>/serve_address` so scripted clients never parse stdout.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional, Sequence

from ..utils.parser import DataclassArgumentParser
from ..utils.registry import register_algorithm

__all__ = ["main"]

ADDRESS_FILE = "serve_address"
LADDER_FILE = "serve_ladder.json"
RC_PREEMPTED = 75  # EX_TEMPFAIL: a drained exit, resumable by a supervisor
RETIER_EVERY = 16  # loop steps between re-tier checks, and fresh dispatches each needs
RETIER_MAX = 2  # rungs a server may add


@register_algorithm(name="serve")
def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..telemetry.core import Telemetry
    from ..utils.device import resolve_device
    from .args import ServeArgs

    parser = DataclassArgumentParser(ServeArgs)
    (args,) = parser.parse_args_into_dataclasses(argv)
    device = resolve_device(args.device)

    root_dir = args.root_dir or os.path.join("logs", "serve", args.env_id)
    run_name = args.run_name or time.strftime("%Y-%m-%d_%H-%M-%S")
    log_dir = os.path.join(root_dir, run_name)
    args.log_dir = log_dir  # side effect: mkdir + args.json dump
    telem = Telemetry(log_dir, role="serve")
    try:
        _serve(args, device, log_dir, telem)
    finally:
        telem.close()


def _serve(args, device, log_dir: str, telem) -> None:
    import torch

    from ..compile.plan import CompilePlan
    from ..telemetry.trace import ensure_run_id, install_profile_signal
    from . import ladder as ladder_mod
    from .batcher import MicroBatcher
    from .params import GraphParams, ParamsStore
    from .policies import build_policy
    from .quant import QuantState
    from .server import ServeServer

    install_profile_signal(log_dir)
    plan = CompilePlan.from_args(args, telem)
    telem.add_gauges(plan.gauges)

    # reloads, re-tier probes and re-tier captures take turns on the card
    card_lock = threading.Lock()
    policy, params, loader = build_policy(args, device)
    store = ParamsStore(loader, params, source=args.ckpt, telem=telem, reload_lock=card_lock)

    spec = ladder_mod.ledger_spec(args.algo)
    ladder_path = os.path.join(log_dir, LADDER_FILE)

    def _size(rungs: list[int]):
        return ladder_mod.size_ladder(policy.step, lambda r: policy.example(store.current()[1], r), rungs, spec,
                                      store_path=ladder_path)

    decisions = _size(ladder_mod.parse_rungs(args.ladder, args.max_batch))
    for d in decisions:
        telem.event("serve.ladder", **d.as_event())
    rungs = [d.rung for d in decisions if d.accepted]

    qstate = None
    if args.quant == "int8":
        qstate = QuantState(policy, args, log_dir, telem=telem)
        telem.add_gauges(qstate.gauges)
        if qstate.accept_rungs(*store.current(), rungs):
            # rebuild the quantized twin in the reload thread, not on the
            # first int8 dispatch after a swap
            store.on_reload = qstate.params_for

    def _is_int8(rung: int) -> bool:
        return qstate is not None and rung in qstate.int8_rungs

    def _step_of(rung: int):
        if _is_int8(rung):
            return qstate.step_for(qstate.params_for(*store.current()))
        return policy.step

    held = GraphParams()

    def _live(rung: int):
        """(version, the params object the rung's graph reads)."""
        version, live = store.current()
        if _is_int8(rung):
            live = qstate.params_for(version, live)
        return version, held.sync("int8" if _is_int8(rung) else "f32", version, live)

    def _inference(step):
        def run(*a):
            with torch.inference_mode():
                return step(*a)
        return run

    def _register(rung: int):
        return plan.register(f"policy_b{rung}", _inference(_step_of(rung)),
                             example=lambda r=rung: policy.example(_live(r)[1], r), adopt=True)

    runners = {rung: _register(rung) for rung in rungs}
    plan.start()

    def dispatch(stacked, pendings, rung):
        version, live = _live(rung)
        return policy.run(runners[rung], live, version, stacked, pendings, rung), version

    batcher = MicroBatcher(
        dispatch, rungs, window_ms=args.batch_window_ms,
        default_deadline_ms=args.deadline_ms, telem=telem,
    )
    server = ServeServer(policy, store, batcher, bind=args.bind, telem=telem)
    stop = threading.Event()
    got_signal: list[str] = []

    def _on_signal(signum, _frame):
        got_signal.append(signal.Signals(signum).name)
        stop.set()

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_signal)

    retier = {"added": 0, "seen": 0}

    def _maybe_retier() -> None:
        """Occupancy-driven re-tier (expansion only): when the dispatches
        since the last look carry far fewer rows than the rung they pad up
        to, size a rung at their mean rows and splice it into the batcher."""
        if retier["added"] >= RETIER_MAX:
            return
        g = batcher.gauges()
        dispatches = int(g["Serve/dispatches"])
        if dispatches - retier["seen"] < RETIER_EVERY:
            return  # a fresh occupancy window, not startup noise
        retier["seen"] = dispatches
        avg_rows = g["Serve/rows_served"] / max(dispatches, 1)
        cand = ladder_mod.derive_rung(avg_rows, batcher.rungs, args.max_batch)
        if cand is None:
            return
        with card_lock:
            sized = _size([min(batcher.rungs), cand])
        d = next(s for s in sized if s.rung == cand)
        retier["added"] += 1  # a refusal consumes the attempt too
        # (the reference passes `rung` twice here, so its re-tier ends in a
        # TypeError, a `serve.retier_error`, every time: ROADMAP Queue C)
        telem.event("serve.retier", occupancy_rows=round(avg_rows, 2), **d.as_event())
        if not d.accepted:
            return
        runners[cand] = _first_call_under(card_lock, _register(cand))
        batcher.set_rungs([*batcher.rungs, cand])

    poller = None
    start_t = time.monotonic()
    try:
        address = server.start()
        # written whole, then renamed into place: a client that polls for
        # the file never reads it half-written
        path = os.path.join(log_dir, ADDRESS_FILE)
        with open(path + ".tmp", "w") as fh:
            fh.write(address + "\n")
        os.replace(path + ".tmp", path)
        print(f"sheepserve: serving {args.algo} v{store.version} on {device} at {address}", flush=True)
        telem.event(
            "serve.start", address=address, algo=args.algo, rungs=rungs,
            version=store.version, device=str(device), quant=args.quant, ckpt=args.ckpt,
            int8_rungs=sorted(qstate.int8_rungs) if qstate is not None else [], run_id=ensure_run_id(),
        )
        telem.add_gauges(server.gauges)
        if args.reload_poll_s > 0 and args.ckpt:
            poller = threading.Thread(target=_poll_reloads, args=(args, store, stop, telem),
                                      name="serve-reload-poll", daemon=True)
            poller.start()
        step = 0
        while not stop.is_set():
            stop.wait(0.05 if args.serve_requests >= 0 or args.dry_run else 0.5)
            step += 1
            if step % RETIER_EVERY == 0:
                # a broken probe must never take a serving loop down
                try:
                    _maybe_retier()
                except Exception as err:
                    telem.event("serve.retier_error", error=f"{type(err).__name__}: {err}"[:300])
            if step % 20 == 0 or args.dry_run:
                elapsed = max(time.monotonic() - start_t, 1e-6)
                telem.interval({"Serve/uptime_seconds": elapsed}, step=server.completed,
                               sps=server.completed / elapsed)
            if args.serve_requests >= 0 and server.completed >= args.serve_requests:
                break
            if args.dry_run:
                break
    finally:
        stop.set()
        if got_signal:
            server.drain()
        telem.event("serve.stop", completed=server.completed, version=store.version,
                    signal=got_signal[0] if got_signal else None)
        server.close()
        if poller is not None:
            poller.join(timeout=max(2.0, 2 * args.reload_poll_s))
        plan.close()
        # final gauge flush so a report sees the last state
        telem.interval({"Serve/uptime_seconds": max(time.monotonic() - start_t, 1e-6)},
                       step=server.completed, sps=0.0)
    if got_signal:
        raise SystemExit(RC_PREEMPTED)


def _first_call_under(lock: threading.Lock, runner):
    """`runner` with its first call (a re-tiered rung's warm-up and capture)
    made holding `lock`."""
    first = [True]

    def call(*a):
        if first[0]:
            with lock:
                out = runner(*a)
            first[0] = False
            return out
        return runner(*a)

    return call


def _poll_reloads(args, store, stop: threading.Event, telem) -> None:
    """Watch --ckpt's directory; hot-reload when its newest valid checkpoint
    is not the one being served. Client RELOAD frames stay available."""
    from ..utils.checkpoint import latest_checkpoint

    ckpt_dir = os.path.dirname(os.path.abspath(args.ckpt))
    while not stop.wait(args.reload_poll_s):
        try:
            latest = latest_checkpoint(ckpt_dir)
        except OSError as err:  # a listing that failed: the next tick retries
            telem.event("serve.reload_poll_error", error=f"{type(err).__name__}: {err}"[:300])
            continue
        if latest and os.path.abspath(latest) != os.path.abspath(store.source or ""):
            store.reload(latest)
