"""`sheeprl_tpu_torch serve` — the batched policy-inference serving tier (the
port of sheeprl_tpu/serve/serve.py).

Wiring, in dependency order:

  1. build the policy from a fresh `--model_argv` init on `--device`
     (policies.py; the CUDA device unless `--device cpu`, and raising when
     CUDA is missing);
  2. the batch ladder: `--ladder` rungs (ladder.py);
  3. hot-reloadable params (params.py), micro-batcher (batcher.py), FLK1
     socket front (server.py);
  4. the serve loop: `Serve/*` telemetry intervals and graceful drain on
     SIGTERM/SIGINT — queued requests are served, NEW requests are shed
     with reason="draining", and the process exits rc 75.
     `--serve_requests` completion stays a plain rc 0.

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
RC_PREEMPTED = 75  # EX_TEMPFAIL: a drained exit, resumable by a supervisor


@register_algorithm(name="serve")
def main(argv: Optional[Sequence[str]] = None) -> None:
    from ..telemetry.core import Telemetry
    from ..utils.device import resolve_device
    from .args import ServeArgs
    from .batcher import MicroBatcher
    from .ladder import parse_rungs
    from .params import ParamsStore
    from .policies import build_policy
    from .server import ServeServer

    parser = DataclassArgumentParser(ServeArgs)
    (args,) = parser.parse_args_into_dataclasses(argv)
    device = resolve_device(args.device)
    if args.quant != "off":
        raise NotImplementedError("--quant int8 is not yet ported")

    root_dir = args.root_dir or os.path.join("logs", "serve", args.env_id)
    run_name = args.run_name or time.strftime("%Y-%m-%d_%H-%M-%S")
    log_dir = os.path.join(root_dir, run_name)
    args.log_dir = log_dir  # side effect: mkdir + args.json dump
    telem = Telemetry(log_dir, role="serve")

    policy, params, loader = build_policy(args, device)
    store = ParamsStore(loader, params, source=args.ckpt, telem=telem)
    rungs = parse_rungs(args.ladder, args.max_batch)

    def dispatch(stacked, pendings, rung):
        version, live = store.current()
        return policy.run(policy.step, live, version, stacked, pendings, rung), version

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

    start_t = time.monotonic()
    try:
        address = server.start()
        with open(os.path.join(log_dir, ADDRESS_FILE), "w") as fh:
            fh.write(address + "\n")
        print(f"sheepserve: serving {args.algo} v{store.version} on {device} at {address}", flush=True)
        telem.event(
            "serve.start", address=address, algo=args.algo, rungs=rungs,
            version=store.version, device=str(device),
        )
        telem.add_gauges(server.gauges)
        step = 0
        while not stop.is_set():
            stop.wait(0.05 if args.serve_requests >= 0 or args.dry_run else 0.5)
            step += 1
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
        # final gauge flush so a report sees the last state
        telem.interval({"Serve/uptime_seconds": max(time.monotonic() - start_t, 1e-6)},
                       step=server.completed, sps=0.0)
        telem.close()
    if got_signal:
        raise SystemExit(RC_PREEMPTED)
