"""The port's `serve` task end to end on the CPU at a tiny `--model_argv`, over
a unix socket: three client sessions (one `reset`) get the answers a direct
`PlayerDV3.step` gives with the same session state; the address file and
the JSONL start/stop and `Serve/*` records exist; and without `--device
cpu` on a machine without CUDA the task raises."""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

TINY_MODEL = (
    "--env_id discrete_dummy --cnn_keys rgb --cnn_channels_multiplier 2 --dense_units 16 "
    "--recurrent_state_size 16 --hidden_size 16 --stochastic_size 4 --discrete_size 4"
)


def _records(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "telemetry.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.mark.timeout(120)
def test_served_answers_equal_direct_player_steps(tmp_path):
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.serve.args import ServeArgs
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.serve.policies import build_policy

    sessions, per_session = 3, 4
    total = sessions * per_session
    argv = ["serve", "--device", "cpu", "--model_argv", TINY_MODEL, "--root_dir", str(tmp_path),
            "--run_name", "r", "--serve_requests", str(total), "--max_batch", "4",
            "--deadline_ms", "0"]  # no shedding: a loaded test machine must not drop a request
    errors: list[BaseException] = []

    def _serve():
        try:
            run(argv)
        except BaseException as err:  # surfaced by the assertion below
            errors.append(err)

    server = threading.Thread(target=_serve, daemon=True)
    server.start()
    run_dir = os.path.join(str(tmp_path), "r")
    addr_file = os.path.join(run_dir, "serve_address")
    deadline = time.monotonic() + 60
    while not os.path.exists(addr_file) and not errors and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not errors, errors
    address = open(addr_file).read().strip()
    assert address.startswith("unix:")

    rng = np.random.default_rng(0)
    plan = {
        f"s{s}": [
            (rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8), s == 1 and i == 2)
            for i in range(per_session)
        ]
        for s in range(sessions)
    }
    answers: dict[str, list[np.ndarray]] = {}

    def _client(sid: str):
        try:
            with ServeClient(address) as client:
                answers[sid] = [
                    client.request({"rgb": obs}, session=sid, reset=reset)[0]["actions"]
                    for obs, reset in plan[sid]
                ]
        except BaseException as err:  # surfaced by the assertion below
            errors.append(err)

    clients = [threading.Thread(target=_client, args=(sid,)) for sid in plan]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=60)
    server.join(timeout=60)
    assert not server.is_alive() and not errors, errors

    # the same weights and noise, rebuilt from the same argv, stepped directly
    args = ServeArgs(device="cpu", model_argv=TINY_MODEL)
    policy, player, _ = build_policy(args, torch.device("cpu"))
    init = policy.init_row(1, player)
    for sid, steps in plan.items():
        state = {k: v[None] for k, v in init.items()}
        for (obs, reset), got in zip(steps, answers[sid]):
            if reset:
                state = {k: v[None] for k, v in init.items()}
            with torch.inference_mode():
                state, acts = policy.step(player, state, {"rgb": torch.from_numpy(obs)})
            np.testing.assert_array_equal(got, acts.numpy())
            assert got.shape == (1, 2) and got.sum() == 1.0

    records = _records(run_dir)
    events = [r.get("event") for r in records]
    assert "serve.start" in events and "serve.stop" in events
    last = [r for r in records if r.get("event") == "interval"][-1]["metrics"]
    assert last["Serve/served_total"] == total
    assert {"Serve/latency_p50_ms", "Serve/latency_p99_ms", "Serve/qps"} <= set(last)


def test_dry_run_writes_address_and_records(tmp_path):
    from sheeprl_tpu_torch.cli import run

    run(["serve", "--device", "cpu", "--model_argv", TINY_MODEL, "--root_dir", str(tmp_path),
         "--run_name", "dry", "--max_batch", "2", "--dry_run"])
    run_dir = os.path.join(str(tmp_path), "dry")
    assert open(os.path.join(run_dir, "serve_address")).read().startswith("unix:")
    events = {r.get("event") for r in _records(run_dir)}
    assert {"serve.start", "serve.stop", "interval"} <= events


def test_serve_without_cuda_raises_unless_cpu_is_asked(tmp_path, monkeypatch):
    from sheeprl_tpu_torch.cli import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(["serve", "--model_argv", TINY_MODEL, "--root_dir", str(tmp_path), "--dry_run"])


@pytest.mark.parametrize("flag", [["--quant", "int8"], ["--ckpt", "some/ckpt"]])
def test_unported_serve_options_raise(tmp_path, flag):
    """Both options once raised here. `--quant int8` for dreamer_v3 is now
    ported: a dry run calibrates, decides each rung and starts
    (tests/test_torch_serve_tier.py holds it against the reference). `--ckpt`
    is ported, and a path that holds no checkpoint raises at start-up, before
    the server listens (tests/test_torch_checkpoint.py serves real ones)."""
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.serve.errors import ServeError

    argv = ["serve", "--device", "cpu", "--model_argv", TINY_MODEL, "--root_dir", str(tmp_path),
            "--run_name", "r", "--max_batch", "2", "--dry_run", *flag]
    if flag[0] == "--ckpt":
        with pytest.raises(ServeError, match="no args.json sidecar"):
            run(argv)
        return
    run(argv)
    records = _records(os.path.join(str(tmp_path), "r"))
    start = next(r for r in records if r.get("event") == "serve.start")
    assert start["quant"] == "int8" and start["rungs"] == [1, 2]
    assert len([r for r in records if r.get("event") == "serve.quant_rung"]) == 2


def test_ladder_auto_is_powers_of_two():
    from sheeprl_tpu_torch.serve.ladder import parse_rungs

    assert parse_rungs("auto", 8) == [1, 2, 4, 8]
    assert parse_rungs("auto", 6) == [1, 2, 4, 6]
    assert parse_rungs("2,1", 8) == [1, 2]
    with pytest.raises(ValueError):
        parse_rungs("1,16", 8)
