"""Serving-tier config (the port of sheeprl_tpu/serve/args.py). `--quant
int8` and `--ckpt` are accepted by the parser and raise "not yet ported"
at startup."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..algos.args import StandardArgs
from ..utils.parser import Arg

SERVE_ALGOS = ("dreamer_v3",)


@dataclasses.dataclass
class ServeArgs(StandardArgs):
    algo: str = Arg(
        default="dreamer_v3",
        help="policy family to serve: 'dreamer_v3' (player step with "
        "server-held per-session recurrent state; requests must be "
        "single-row and carry a 'session' id)",
    )
    ckpt: Optional[str] = Arg(
        default=None,
        help="checkpoint to serve (not yet ported: reading the reference's "
        "orbax checkpoints needs orbax). Omitted: a fresh model is "
        "initialized from --model_argv and --seed",
    )
    bind: str = Arg(
        default="unix:auto",
        help="listen address: 'unix:auto' (fresh socket in a tempdir; the "
        "resolved address is printed and written to <log_dir>/serve_address), "
        "'unix:PATH', or 'tcp:HOST:PORT' (port 0 picks an ephemeral port)",
    )
    batch_window_ms: float = Arg(
        default=2.0,
        help="micro-batching window: after the first queued request, wait up "
        "to this long for more requests before dispatching (a full ladder "
        "rung dispatches immediately)",
    )
    deadline_ms: float = Arg(
        default=100.0,
        help="default per-request deadline; a request still queued past it "
        "is shed with a SHED frame (retry_after hint). Requests may override "
        "per-call; <=0 disables shedding",
    )
    max_batch: int = Arg(default=8, help="largest batch rung of the serving ladder")
    ladder: str = Arg(
        default="auto",
        help="batch-ladder rungs: 'auto' = powers of two up to --max_batch, or "
        "an explicit comma list like '1,2,8'",
    )
    serve_requests: int = Arg(
        default=-1,
        help="exit cleanly after this many completed requests (responses + "
        "sheds); -1 serves until SIGTERM/SIGINT",
    )
    model_argv: Optional[str] = Arg(
        default=None,
        help="space-separated training-args tokens (e.g. '--env_id "
        "discrete_dummy --cnn_keys rgb') used to init a fresh model",
    )
    quant: str = Arg(
        default="off",
        help="policy-inference quantization ('int8' is not yet ported)",
    )

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "algo" and value not in SERVE_ALGOS:
            raise ValueError(f"algo must be one of {SERVE_ALGOS}, got {value!r}")
        if name == "max_batch" and int(value) < 1:
            raise ValueError(f"max_batch must be >= 1, got {value!r}")
        if name == "quant" and value not in ("off", "int8"):
            raise ValueError(f"quant must be 'off' or 'int8', got {value!r}")
        super().__setattr__(name, value)
