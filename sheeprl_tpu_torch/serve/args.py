"""Serving-tier config (the port of sheeprl_tpu/serve/args.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..algos.args import StandardArgs
from ..utils.parser import Arg

SERVE_ALGOS = ("sac", "dreamer_v3")


@dataclasses.dataclass
class ServeArgs(StandardArgs):
    algo: str = Arg(
        default="dreamer_v3",
        help="policy family to serve: 'sac' (greedy actor over vector obs; "
        "requests carry an 'obs' matrix of any row count up to the largest "
        "rung) or 'dreamer_v3' (player step with server-held per-session "
        "recurrent state; requests must be single-row and carry a 'session' id)",
    )
    ckpt: Optional[str] = Arg(
        default=None,
        help="checkpoint directory to serve (the port's format: a training "
        "run's <run_dir>/checkpoints/ckpt_<step>); the model's config comes "
        "from its args.json sidecar and --model_argv is ignored. A client "
        "RELOAD moves the server to another checkpoint. Omitted: a fresh "
        "model is initialized from --model_argv and --seed",
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
        "an explicit comma list like '1,2,8'; each rung is then sized against "
        "the serving memory budget (SHEEPRL_TPU_SERVE_MEM_MB, default 512) from "
        "its measured peak, memoized in <log_dir>/serve_ladder.json",
    )
    reload_poll_s: float = Arg(
        default=0.0,
        help=">0: watch the checkpoint directory of --ckpt every this many "
        "seconds and hot-reload a newer valid checkpoint automatically "
        "(clients can always trigger an explicit reload with a RELOAD "
        "frame). Reloads are double-buffered: version N keeps serving "
        "until N+1 is fully loaded, and keeps serving on a failed reload",
    )
    serve_requests: int = Arg(
        default=-1,
        help="exit cleanly after this many completed requests (responses + "
        "sheds); -1 serves until SIGTERM/SIGINT",
    )
    model_argv: Optional[str] = Arg(
        default=None,
        help="space-separated training-args tokens (e.g. '--env_id "
        "discrete_dummy --cnn_keys rgb' for dreamer_v3, '--actor_hidden_size "
        "32' for sac) used to init a fresh model",
    )
    quant: str = Arg(
        default="off",
        help="policy-inference quantization: 'int8' calibrates per-channel "
        "scales, builds an int8 variant of every ladder rung, and "
        "accepts each rung by timing under the --quant_bound quality receipt: "
        "a rung whose divergence exceeds the bound is disqualified and keeps "
        "serving f32. 'off' (default) serves f32",
    )
    # serving wants its graphs before the first request, as the reference
    # wants its AOT executables
    warm_compile: str = Arg(
        default="on",
        help="capture the per-rung policy steps as CUDA graphs at startup "
        "('on', the default for serving) or at each rung's first dispatch "
        "('off'); on the CPU the steps run directly",
    )
    quant_bound: float = Arg(
        default=0.05,
        help="max tolerated action divergence (max |delta| over the held-out "
        "calibration set) for accepting an int8 rung; the measured divergence "
        "is stored next to the winner in <log_dir>/serve_quant.json",
    )

    def __setattr__(self, name: str, value: Any) -> None:
        if name == "algo" and value not in SERVE_ALGOS:
            raise ValueError(f"algo must be one of {SERVE_ALGOS}, got {value!r}")
        if name == "max_batch" and int(value) < 1:
            raise ValueError(f"max_batch must be >= 1, got {value!r}")
        if name == "quant" and value not in ("off", "int8"):
            raise ValueError(f"quant must be 'off' or 'int8', got {value!r}")
        if name == "quant_bound" and float(value) <= 0.0:
            raise ValueError(f"quant_bound must be > 0, got {value!r}")
        if name == "reload_poll_s" and float(value) < 0.0:
            raise ValueError(f"reload_poll_s must be >= 0, got {value!r}")
        super().__setattr__(name, value)
