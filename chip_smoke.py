#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sheeprl_tpu_torch`) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each reported on its own lines; any failure exits non-zero before
the final line:

  1. device: the card's name and power limit (nvidia-smi); TF32 off, so
     the plain versions are true float32;
  2. build: every kernel of the port compiled from `sheeprl_tpu_torch/csrc/`
     with nvcc for sm_90a, one nvcc per source, started together;
  3. kernels: each kernel against its plain PyTorch version at the shapes
     the serving path gives it (and the GRU at training batch 1024), in
     float32 and bfloat16, with CUDA-event times for the kernel, the plain
     version and a library yardstick the port never calls, and the bound
     from bytes (3.35 TB/s) and operations (67 TFLOP/s f32, 989 TFLOP/s
     bf16);
  4. slice: `sheeprl_tpu_torch serve --algo dreamer_v3` at DreamerV3's full
     default width on `discrete_dummy` pixels, rungs 1/2/4/8, 1,024 timed
     requests from 8 concurrent sessions (some with `reset`) after one
     warm-up request per client; every answer must be a one-hot action,
     the launch counts must be 4 (conv) and 1 (GRU) per dispatched step,
     and one served step must match the same step run with the plain
     versions on the card;
  5. profile: host wall time of direct player steps at rungs 1 and 8, and a
     torch.profiler window over rung-8 steps (the kernels' device time, the
     device's busy share, and a chrome trace).

Then one JSON line with every kernel's numbers, the nvidia-smi line, and
`{"ok": true, "device": {...}}` as the last line. Detailed results (report.json,
the trace, the serve run's records) go to `build/chip_smoke/`, or to the
directory given with `--out DIR`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "build", "chip_smoke")  # --out DIR replaces it
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 outside the tensor cores; bf16 dense
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # atol and rtol of kernel vs plain version
TIMED_LAUNCHES = 60
# 1,024 timed requests: p99 then has about ten samples beyond it
SERVE_SESSIONS, SERVE_PER_SESSION = 8, 128
SERVE_MODEL = "--env_id discrete_dummy --cnn_keys rgb"  # DreamerV3's defaults: full width


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def device_ms(torch, fn) -> float:
    """Median device time of one call of `fn`, from CUDA events around each
    of TIMED_LAUNCHES back-to-back calls. A sleep kernel queued first keeps
    the device busy while the host enqueues, so the events see device time
    rather than the host's launch gaps."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(TIMED_LAUNCHES + 1)]
    torch.cuda._sleep(50_000_000)
    for i in range(TIMED_LAUNCHES):
        events[i].record()
        fn()
    events[-1].record()
    torch.cuda.synchronize()
    times = sorted(events[i].elapsed_time(events[i + 1]) for i in range(TIMED_LAUNCHES))
    return times[len(times) // 2]


def errors(torch, got, want, dtype_name):
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    tol = TOL[dtype_name]
    max_abs = float(diff.max())
    max_rel = float((diff / b.abs().clamp_min(1e-2)).max())
    ok = bool((diff <= tol + tol * b.abs()).all()) and bool(torch.isfinite(a).all())
    return max_abs, max_rel, ok


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_gru(torch, F, gru, batch, dtype, gen):
    dev = torch.device("cuda")
    hidden, dx = 512, 512
    k, n = dx + hidden, 3 * hidden
    x = torch.randn(batch, dx, generator=gen).to(dev, dtype)
    h = torch.tanh(torch.randn(batch, hidden, generator=gen)).to(dev, dtype)
    w = (torch.randn(n, k, generator=gen) * (2.0 / (k + n)) ** 0.5).to(dev, dtype)
    scale = (1.0 + 0.1 * torch.randn(n, generator=gen)).to(dev)
    offset = (0.1 * torch.randn(n, generator=gen)).to(dev)
    eps = 1e-5
    before = gru.layernorm_gru_cell.launches
    got = gru.layernorm_gru_cell(x, h, w, scale, offset, eps)
    torch.cuda.synchronize()
    if gru.layernorm_gru_cell.launches != before + 1:
        raise RuntimeError("layernorm_gru_cell did not count its launch")
    want = gru.layernorm_gru_cell_plain(x, h, w, scale, offset, eps)
    name = str(dtype).split(".")[-1]
    max_abs, max_rel, ok = errors(torch, got, want, name)

    def library():
        parts = torch.matmul(torch.cat([x, h], dim=-1), w.t())
        parts = F.layer_norm(parts.float(), (n,), scale, offset, eps)
        r, c, u = parts.chunk(3, dim=-1)
        upd = torch.sigmoid(u - 1.0)
        return (upd * torch.tanh(torch.sigmoid(r) * c) + (1.0 - upd) * h.float()).to(dtype)

    ms = device_ms(torch, lambda: gru.layernorm_gru_cell(x, h, w, scale, offset, eps))
    plain_ms = device_ms(torch, lambda: gru.layernorm_gru_cell_plain(x, h, w, scale, offset, eps))
    library_ms = device_ms(torch, library)
    item = x.element_size()
    nbytes = item * (x.numel() + h.numel() + w.numel() + batch * hidden) + 4 * 2 * n
    flops = 2.0 * batch * k * n
    bound_ms, bound_by = bound(nbytes, flops, name)
    return dict(kernel="layernorm_gru_cell", shape=f"B={batch} x[{batch},{dx}] h[{batch},{hidden}] w[{n},{k}]",
                dtype=name, max_abs_err=max_abs, max_rel_err=max_rel, within_tol=ok, tol=TOL[name],
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, flops=flops)


STAGES = [(3, 32, 64), (32, 64, 32), (64, 128, 16), (128, 256, 8)]  # DreamerV3 encoder at width 32


def check_conv(torch, F, cnn, n, stage, dtype, gen):
    dev = torch.device("cuda")
    cin, cout, size = stage
    if cin == 3:
        x = torch.rand(n, size, size, cin, generator=gen)  # pixels / 255
    else:
        x = F.silu(torch.randn(n, size, size, cin, generator=gen))
    x = x.to(dev, dtype)
    fan_in, fan_out = 16 * cin, 16 * cout
    w = (torch.randn(4, 4, cin, cout, generator=gen) * (2.0 / (fan_in + fan_out)) ** 0.5).to(dev, dtype)
    scale = (1.0 + 0.1 * torch.randn(cout, generator=gen)).to(dev)
    offset = (0.1 * torch.randn(cout, generator=gen)).to(dev)
    eps = 1e-3
    before = cnn.conv_ln_silu.launches
    got = cnn.conv_ln_silu(x, w, scale, offset, eps)
    torch.cuda.synchronize()
    if cnn.conv_ln_silu.launches != before + 1:
        raise RuntimeError("conv_ln_silu did not count its launch")
    want = cnn.conv_ln_silu_plain(x, w, scale, offset, eps)
    name = str(dtype).split(".")[-1]
    max_abs, max_rel, ok = errors(torch, got, want, name)
    w_oihw = w.permute(3, 2, 0, 1).contiguous()

    def library():  # cuDNN on the NHWC (channels_last) view, in the working dtype
        y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=2, padding=1)
        y = F.layer_norm(y.permute(0, 2, 3, 1).float(), (cout,), scale, offset, eps)
        return F.silu(y).to(dtype)

    ms = device_ms(torch, lambda: cnn.conv_ln_silu(x, w, scale, offset, eps))
    plain_ms = device_ms(torch, lambda: cnn.conv_ln_silu_plain(x, w, scale, offset, eps))
    library_ms = device_ms(torch, library)
    item = x.element_size()
    pixels = n * (size // 2) * (size // 2)
    nbytes = item * (x.numel() + w.numel() + pixels * cout) + 4 * 2 * cout
    flops = 2.0 * pixels * cout * 16 * cin
    bound_ms, bound_by = bound(nbytes, flops, name)
    return dict(kernel="conv_ln_silu", shape=f"N={n} {cin}->{cout} @{size}x{size}", dtype=name,
                max_abs_err=max_abs, max_rel_err=max_rel, within_tol=ok, tol=TOL[name], ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, flops=flops)


def fmt(r: dict) -> str:
    return (
        f"  {r['kernel']:<19} {r['shape']:<42} {r['dtype']:<8} max_abs={r['max_abs_err']:.3e} "
        f"max_rel={r['max_rel_err']:.3e} tol={r['tol']:g} ok={r['within_tol']} "
        f"ms={r['ms']:.5f} plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f} "
        f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']})"
    )


# ---------------------------------------------------------------------------
# phase 4: the served slice
# ---------------------------------------------------------------------------


def drive_serve(np, run, ServeClient, root_dir: str, extra_argv=()):
    """Serve at full DreamerV3 width through the CLI entry point, in this
    process, and drive it from concurrent client sessions. Each client first
    sends one untimed warm-up request (on a session of its own), then all
    start together. Returns the per-session request plans, answers, timed
    latencies, the timed wall time and the warm-up latencies."""
    total = SERVE_SESSIONS * (SERVE_PER_SESSION + 1)
    argv = ["serve", "--algo", "dreamer_v3", "--model_argv", SERVE_MODEL, *extra_argv,
            "--root_dir", root_dir, "--run_name", "serve", "--max_batch", "8", "--ladder", "auto",
            "--serve_requests", str(total), "--deadline_ms", "0"]
    failures: list[BaseException] = []

    def _serve():
        try:
            run(argv)
        except BaseException as err:  # reported by the caller
            failures.append(err)

    server = threading.Thread(target=_serve, name="chip-smoke-serve", daemon=True)
    server.start()
    addr_file = os.path.join(root_dir, "serve", "serve_address")
    deadline = time.monotonic() + 300
    while not os.path.exists(addr_file):
        if failures or time.monotonic() > deadline:
            raise RuntimeError(f"server did not come up: {failures}")
        time.sleep(0.05)
    address = open(addr_file).read().strip()
    rng = np.random.default_rng(0)
    plans = {
        f"s{s}": [
            (rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8), s % 2 == 1 and i == SERVE_PER_SESSION // 2)
            for i in range(SERVE_PER_SESSION)
        ]
        for s in range(SERVE_SESSIONS)
    }
    answers: dict[str, list] = {}
    latencies: list[float] = []
    warmups: list[float] = []
    lock = threading.Lock()
    started: list[float] = []
    barrier = threading.Barrier(SERVE_SESSIONS, action=lambda: started.append(time.perf_counter()), timeout=300)

    def _client(sid: str):
        try:
            with ServeClient(address) as client:
                t0 = time.perf_counter()
                client.request({"rgb": plans[sid][0][0]}, session=f"warm-{sid}")
                with lock:
                    warmups.append((time.perf_counter() - t0) * 1e3)
                barrier.wait()
                out = []
                for obs, reset in plans[sid]:
                    t0 = time.perf_counter()
                    res, _ = client.request({"rgb": obs}, session=sid, reset=reset)
                    dt = (time.perf_counter() - t0) * 1e3
                    with lock:
                        latencies.append(dt)
                    out.append(res["actions"])
                answers[sid] = out
        except BaseException as err:  # reported by the caller
            failures.append(err)
            barrier.abort()

    clients = [threading.Thread(target=_client, args=(sid,)) for sid in plans]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=600)
    wall = time.perf_counter() - started[0] if started else float("nan")
    server.join(timeout=120)
    if failures:
        raise RuntimeError(f"serve phase failed: {failures!r}")
    if server.is_alive() or any(t.is_alive() for t in clients):
        raise RuntimeError("serve or client threads did not finish")
    return plans, answers, latencies, wall, warmups


def plain_step_check(torch, np, plans, answers, device):
    """Rebuild the served model (same argv and seed, so the same weights and
    noise), run one rung-8 step over the sessions' first requests with the
    kernels and again with the modules' kernel calls pointed at the plain
    versions. -> (recurrent max_abs, stochastic max_abs, whether the served,
    kernel and plain actions are all equal)."""
    import sheeprl_tpu_torch.nn.blocks as blocks_mod
    import sheeprl_tpu_torch.nn.recurrent as recurrent_mod
    from sheeprl_tpu_torch.ops.kernels import cnn, gru
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.policies import build_policy

    args = ServeArgs(model_argv=SERVE_MODEL, device=str(device))
    policy, player, _ = build_policy(args, device)
    init = policy.init_row(1, player)
    first = [plans[f"s{s}"][0][0] for s in range(SERVE_SESSIONS)]
    obs = {"rgb": torch.from_numpy(np.concatenate(first)).to(device)}
    state0 = {k: torch.stack([v] * SERVE_SESSIONS) for k, v in init.items()}
    with torch.inference_mode():
        k_state, k_acts = policy.step(player, state0, obs)
        saved = (recurrent_mod.layernorm_gru_cell, blocks_mod.conv_ln_silu)
        recurrent_mod.layernorm_gru_cell = gru.layernorm_gru_cell_plain
        blocks_mod.conv_ln_silu = cnn.conv_ln_silu_plain
        try:
            p_state, p_acts = policy.step(player, state0, obs)
        finally:
            recurrent_mod.layernorm_gru_cell, blocks_mod.conv_ln_silu = saved
    rec_err = float((k_state["recurrent"] - p_state["recurrent"]).abs().max())
    sto_err = float((k_state["stochastic"] - p_state["stochastic"]).abs().max())
    served_first = np.concatenate([answers[f"s{s}"][0] for s in range(SERVE_SESSIONS)])
    acts_equal = bool(torch.equal(k_acts, p_acts)) and bool(
        np.array_equal(served_first, k_acts.float().cpu().numpy())
    )
    return rec_err, sto_err, acts_equal


def profile_steps(torch, np, device, steps: int = 20):
    """Where a served step's time goes: host wall time of direct player steps
    at rungs 1 and 8 (synchronized, no profiler), and a torch.profiler window
    over rung-8 steps for the kernels' device time. The busy share is the
    kernels' device time over the unprofiled rung-8 wall time."""
    from torch.profiler import ProfilerActivity, profile

    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.policies import build_policy

    policy, player, _ = build_policy(ServeArgs(model_argv=SERVE_MODEL, device=str(device)), device)
    init = policy.init_row(1, player)
    rng = np.random.default_rng(1)
    out = {}
    with torch.inference_mode():
        for rung in (1, 8):
            state = {k: torch.stack([v] * rung) for k, v in init.items()}
            obs = {"rgb": torch.from_numpy(rng.integers(0, 256, (rung, 64, 64, 3), dtype=np.uint8)).to(device)}
            for _ in range(5):
                policy.step(player, state, obs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                policy.step(player, state, obs)
            torch.cuda.synchronize()
            out[f"step_ms_rung{rung}"] = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                policy.step(player, state, obs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(OUT_DIR, "trace_rung8.json"))
    kernels: dict[str, list] = {}
    for e in prof.events():  # device-side events only: the kernels themselves
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = kernels.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    rows = sorted(((k, ms, c) for k, (ms, c) in kernels.items()), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / steps
    out.update(profiled_wall_ms_per_step=wall_ms / steps, device_ms_per_step=device_ms,
               launches_per_step=sum(r[2] for r in rows) / steps,
               device_busy_share=device_ms / out["step_ms_rung8"],
               top=[dict(name=k, ms_per_step=ms / steps, calls_per_step=c / steps) for k, ms, c in rows[:12]])
    return out


def main() -> int:
    global OUT_DIR
    parser = argparse.ArgumentParser(description="smoke run of the PyTorch/CUDA port on one card")
    parser.add_argument("--out", default=OUT_DIR, help="directory for report.json, the trace and logs")
    OUT_DIR = os.path.abspath(parser.parse_args().out)
    try:
        import numpy as np
        import torch
        import torch.nn.functional as F
    except ImportError as err:
        print(f"chip_smoke: FAIL: {err}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this smoke needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from sheeprl_tpu_torch.cli import run
        from sheeprl_tpu_torch.ops.kernels import build, cnn, gru
        from sheeprl_tpu_torch.serve.client import ServeClient
    except ImportError as err:
        print(f"chip_smoke: FAIL: cannot import the port ({err}); run from the root of a checkout",
              file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    report: dict = {}

    # -- phase 1: device --------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| count {torch.cuda.device_count()} | tf32 off")
    report["device"] = {"name": name, "smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- phase 2: build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(build.SOURCES)} built for sm_90a in {build_s:.2f} s")
    for src in build.SOURCES:
        for line in build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")
    report["build_seconds"] = build_s

    # -- phase 3: kernels against their plain versions --------------------------
    gen = torch.Generator().manual_seed(0)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (1, 8, 1024):
            results.append(check_gru(torch, F, gru, batch, dtype, gen))
            log("[kernels]" + fmt(results[-1]))
        for n in (1, 8):
            for stage in STAGES:
                results.append(check_conv(torch, F, cnn, n, stage, dtype, gen))
                log("[kernels]" + fmt(results[-1]))
    report["kernel_checks"] = results
    bad = [r for r in results if not r["within_tol"]]
    if bad:
        raise RuntimeError(f"{len(bad)} kernel checks out of tolerance: {[r['shape'] for r in bad]}")
    log(f"[kernels] layernorm_gru_cell ok, conv_ln_silu ok: {len(results)} checks within tolerance")

    # -- phase 4: the served slice ---------------------------------------------
    root_dir = os.path.join(OUT_DIR, "serve_logs")
    shutil.rmtree(root_dir, ignore_errors=True)  # a stale serve_address would be dialled
    gru.layernorm_gru_cell.launches = 0
    cnn.conv_ln_silu.launches = 0
    plans, answers, latencies, wall, warmups = drive_serve(np, run, ServeClient, root_dir)
    launches = {"layernorm_gru_cell": gru.layernorm_gru_cell.launches,
                "conv_ln_silu": cnn.conv_ln_silu.launches}
    with open(os.path.join(root_dir, "serve", "telemetry.jsonl")) as fh:
        records = [json.loads(line) for line in fh if line.strip()]
    gauges = [r for r in records if r.get("event") == "interval"][-1]["metrics"]
    dispatches = int(gauges["Serve/dispatches"])
    served = int(gauges["Serve/served_total"])
    total = SERVE_SESSIONS * (SERVE_PER_SESSION + 1)  # the warm-ups included
    n_answers = sum(len(v) for v in answers.values())
    one_hot = all(
        a.shape == (1, 2) and set(np.unique(a).tolist()) <= {0.0, 1.0} and a.sum() == 1.0
        for v in answers.values() for a in v
    )
    log(f"[slice] {n_answers} answers from {len(answers)} sessions, {served} served in {dispatches} "
        f"dispatches; all one-hot: {one_hot}; launches {launches}")
    if n_answers != SERVE_SESSIONS * SERVE_PER_SESSION or served != total or not one_hot:
        raise RuntimeError("the served slice did not answer every request with a one-hot action")
    if launches != {"layernorm_gru_cell": dispatches, "conv_ln_silu": 4 * dispatches}:
        raise RuntimeError(f"launch counts {launches} != 1x / 4x the {dispatches} dispatched steps")

    # one served step vs the same step with the plain versions, on the card
    rec_err, sto_err, acts_equal = plain_step_check(torch, np, plans, answers, torch.device("cuda"))
    log(f"[slice] served step vs plain versions on the card (rung 8): recurrent max_abs={rec_err:.3e} "
        f"stochastic max_abs={sto_err:.3e} (tol 1e-4); actions equal (served, kernel, plain): {acts_equal}")
    if rec_err > 1e-4 or sto_err > 1e-4 or not acts_equal:
        raise RuntimeError("served step disagrees with the plain-version step")

    lat = sorted(latencies)
    p50, p99 = lat[len(lat) // 2], lat[min(int(0.99 * len(lat)), len(lat) - 1)]
    qps = n_answers / wall
    log(f"[slice] client latency p50={p50:.3f} ms p99={p99:.3f} ms, {qps:.1f} qps over {wall:.2f} s "
        f"({SERVE_SESSIONS} concurrent sessions, after one warm-up request each: first-request "
        f"latency max {max(warmups):.1f} ms); server gauges (warm-ups included) "
        f"p50={gauges['Serve/latency_p50_ms']:.3f} ms p99={gauges['Serve/latency_p99_ms']:.3f} ms "
        f"occupancy={gauges['Serve/batch_occupancy']:.3f}")
    report["slice"] = dict(answers=n_answers, dispatches=dispatches, launches=launches,
                           p50_ms=p50, p99_ms=p99, qps=qps, wall_s=wall, warmup_ms=warmups,
                           latencies_ms=latencies, server_gauges=gauges,
                           plain_check=dict(recurrent_max_abs=rec_err, stochastic_max_abs=sto_err))

    # -- the kernels line: main-path shapes (rung 8, float32) -------------------
    def main_path(kernel):
        return [r for r in results if r["kernel"] == kernel and r["dtype"] == "float32"
                and (r["shape"].startswith("B=8 ") or r["shape"].startswith("N=8 "))]

    kernels = []
    for kernel, source, replaces in (
        ("layernorm_gru_cell", "sheeprl_tpu_torch/csrc/ln_gru.cu", "sheeprl_tpu/ops/pallas_kernels.py:224"),
        ("conv_ln_silu", "sheeprl_tpu_torch/csrc/conv_ln_silu.cu", "sheeprl_tpu/ops/pallas_cnn.py:177"),
    ):
        rows = main_path(kernel)  # the GRU's one launch, or the four encoder stages of one step
        t_bytes = sum(r["bytes"] for r in rows) / HBM_BYTES_PER_S * 1e3
        t_ops = sum(r["flops"] for r in rows) / PEAK_FLOPS["float32"] * 1e3
        kernels.append({
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
        })
    report["kernels"] = kernels

    # -- phase 5: where a served step's time goes ------------------------------
    prof = profile_steps(torch, np, torch.device("cuda"))
    log(f"[profile] host wall per step: rung 1 {prof['step_ms_rung1']:.3f} ms, rung 8 "
        f"{prof['step_ms_rung8']:.3f} ms; rung 8 kernels: {prof['launches_per_step']:.0f} launches, "
        f"{prof['device_ms_per_step']:.4f} ms device time a step, busy share "
        f"{prof['device_busy_share']:.3f} (profiled wall {prof['profiled_wall_ms_per_step']:.3f} ms)")
    for row in prof["top"]:
        log(f"[profile]   {row['ms_per_step']:.4f} ms x{row['calls_per_step']:.0f}  {row['name'][:90]}")
    report["profile"] = prof
    with open(os.path.join(OUT_DIR, "report.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=str)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAIL", file=sys.stderr, flush=True)
        rc = 1
    sys.exit(rc)
