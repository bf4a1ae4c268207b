#!/usr/bin/env python3
"""Phase 18 of `chip_smoke.py`, and the phase alone: Plan2Explore on
DreamerV2 and DreamerV1 on the card at their default widths (P2E-DV2 on
discrete_dummy pixels, P2E-DV1 on continuous_dummy pixels). Each run is
counted on the device (no port kernel on either path) and switches from
exploration to the task in its middle, so that both programs' graphs are
captured and replayed; each is resumed from a checkpoint after the switch
(the resumed run keeps the task program) and ends with the task actor's
test episodes. Then one exploring step of each on the card against the CPU
at B 2, and each graphed step (both programs' gradient steps, one
player step an algorithm) against its eager self, bit for bit under
deterministic cuDNN, timed. Alone it builds the kernels first.
Run from the root of a checkout, on one card:

    python3 tools/torch_p2e_phase.py [--out DIR]

The phase's lines go to stdout, its report to DIR/p2e.json. Exits non-zero
without a card or when a check of the phase fails.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each run at its algorithm's defaults (P2E-DV2: cnn multiplier 48, dense
# 400, 32 x 32 latents, recurrent and hidden 400, 10 members, B 16 x T 50,
# horizon 15; P2E-DV1: multiplier 32, dense 400, a 60-wide Gaussian state,
# recurrent and hidden 400, 10 members, B 50 x T 50), its depth cut: action
# repeat 2, so 70 player steps; the first gradient steps at step 64, where
# the ring holds a window, then one a step; the switch at step 67
# (`exploration_steps // action_repeat`), so 4 (V2: 2 of pretraining) or 3
# exploring gradient steps and 4 of the task; a checkpoint with the buffer
# at step 68, after the switch, and at the last
P2E_RUNS = {
    "p2e_dv2 pixels": ["p2e_dv2", "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "1",
                       "--buffer_size", "512", "--learning_starts", "128", "--train_every", "2", "--pretrain_steps",
                       "2", "--exploration_steps", "134", "--total_steps", "140", "--checkpoint_every", "68",
                       "--checkpoint_buffer"],
    "p2e_dv1 pixels": ["p2e_dv1", "--env_id", "continuous_dummy", "--cnn_keys", "rgb", "--num_envs", "1",
                       "--buffer_size", "512", "--learning_starts", "128", "--train_every", "2", "--gradient_steps",
                       "1", "--exploration_steps", "134", "--total_steps", "140", "--checkpoint_every", "68",
                       "--checkpoint_buffer"],
}
P2E_SWITCH, P2E_RESUME = 67, 68
# the card-vs-CPU step: the default widths, the batch cut to 2 rows of T 50
P2E_CPU_BATCH = 2
TARGETS = ("target_critic_task", "target_critic_exploration")


def _modules(algo: str):
    import importlib

    main = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.{algo}")
    agent = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.agent")
    args_mod = importlib.import_module(f"sheeprl_tpu_torch.algos.{algo}.args")
    return main, agent, getattr(args_mod, "P2EDV2Args" if algo == "p2e_dv2" else "P2EDV1Args")


_TEMPLATES: dict = {}


def p2e_setup(torch, np, algo: str, device, batch: int | None = None):
    """A default-width P2E-DV2 (discrete_dummy pixels, 2 actions) or P2E-DV1
    (continuous_dummy pixels, 2 actions) train state built by the
    package's own functions (copies of one seeded build), one [T, B] batch
    (`batch` rows, the default B when None) from a fixed seed. -> (args,
    state, data, draws(generator, exploring) on `device`, {exploring: the
    train step}, the family)."""
    from sheeprl_tpu_torch.envs import spaces

    main, agent, args_cls = _modules(algo)
    continuous = algo == "p2e_dv1"
    args = args_cls()
    if batch is not None:
        args.per_rank_batch_size = batch
    if algo not in _TEMPLATES:
        _TEMPLATES[algo] = agent.build_models(torch.Generator().manual_seed(0), [2], continuous, args,
                                              {"rgb": spaces.Box(0, 255, (64, 64, 3), np.uint8)}, ["rgb"], [])
    models = [copy.deepcopy(m).to(device) for m in _TEMPLATES[algo]]
    fam = main.P2E_DV2 if algo == "p2e_dv2" else main.P2E_DV1
    state = fam.state(*models, *fam.make_optimizers(args, *models))
    T, B = args.per_rank_sequence_length, args.per_rank_batch_size
    rng = np.random.default_rng(0)
    dones = np.zeros((T, B, 1), np.float32)
    dones[3::4, ::3] = 1.0  # the dummy envs' episodes: 4 rows
    batch_np = {"rgb": rng.integers(0, 256, (T, B, 64, 64, 3), dtype=np.uint8),
                "actions": (rng.uniform(-1, 1, (T, B, 2)).astype(np.float32) if continuous
                            else np.eye(2, dtype=np.float32)[rng.integers(0, 2, (T, B))]),
                "rewards": rng.normal(size=(T, B, 1)).astype(np.float32), "dones": dones}
    if not continuous:
        batch_np["is_first"] = np.concatenate([np.zeros((1, B, 1), np.float32), dones[:-1]])
    data = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(device)

    def draws(generator, exploring: bool):
        return to(main.draw_noise(args, T, B, [2], generator, "cpu", continuous, exploring))

    steps = {e: main.make_train_step(args, ["rgb"], [], [2], continuous, exploring=e) for e in (True, False)}
    return args, state, data, draws, steps, fam


def card_cpu_check(cs, torch, np, algo: str, device) -> dict:
    """One default-width exploring step (the batch cut to P2E_CPU_BATCH
    rows) on the card against the same step on the CPU from the same state,
    batch and draws: every metric at the smoke's train tolerances, every
    trained parameter within 2 lr + 1e-6, the target critics within 1e-6.
    -> the check's numbers."""
    sides = {}
    for dev in (device, torch.device("cpu")):
        args, state, data, draws, steps, fam = p2e_setup(torch, np, algo, dev, P2E_CPU_BATCH)
        tau = (1.0,) if fam.target_critic else ()
        noise = draws(torch.Generator().manual_seed(1), True)
        t0 = time.perf_counter()
        metrics = steps[True](state, data, *tau, noise)
        seconds = time.perf_counter() - t0
        names = fam.moved + (TARGETS if fam.target_critic else ())
        params = {m: {k: v.detach().cpu() for k, v in getattr(state, m).state_dict().items()} for m in names}
        sides[dev.type] = (metrics, params, seconds)
    (card, p_card, s_card), (cpu, p_cpu, s_cpu) = sides["cuda"], sides["cpu"]
    bad = [k for k in cpu if abs(card[k] - cpu[k]) > cs.TRAIN_METRIC_ATOL + cs.TRAIN_METRIC_RTOL * abs(cpu[k])]
    lrs = {"world_model": args.world_lr, "actor_task": args.actor_lr, "critic_task": args.critic_lr,
           "actor_exploration": args.actor_lr, "critic_exploration": args.critic_lr, "ensembles": args.ensemble_lr}
    param_err = {m: max(float((p_card[m][k] - p_cpu[m][k]).abs().max()) for k in p_cpu[m])
                 / (2 * lrs[m] + 1e-6 if m in lrs else 1e-6) for m in p_cpu}
    return dict(card=card, cpu=cpu, metric_bad=bad, param_err=param_err, card_seconds=s_card, cpu_seconds=s_cpu)


def graph_cases(cs, torch, np, device) -> list[dict]:
    """Each P2E gradient step (exploring and task) against its eager self at
    the default widths (`graph_case(eager_once=True)`), with cuDNN's
    deterministic algorithms: the replays must match the eager calls bit
    for bit, at tau 1 and 0; and one player step an algorithm, P2E-DV2's exploration actor and
    P2E-DV1's task actor (the other actor's step is the same program over
    other weights: `tests/test_torch_cuda.py::test_graphed_p2e_steps_equal_eager_bit_for_bit`):
    each graphed step's host wall, device time, launches and busy share."""
    reports = []
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for algo, player_program in (("p2e_dv2", "exploring"), ("p2e_dv1", "task")):
            for exploring, program in ((True, "exploring"), (False, "task")):
                def train_build(algo=algo, exploring=exploring):
                    args, state, data, draws, steps, fam = p2e_setup(torch, np, algo, device)
                    gen = torch.Generator().manual_seed(7)
                    calls = [(state, data, *((torch.full((), tau, device=device),) if fam.target_critic else ()),
                              draws(gen, exploring)) for tau in (1.0, 0.0)]

                    def params():
                        names = fam.moved + (TARGETS if fam.target_critic else ())
                        return {f"{m}.{k}": v for m in names for k, v in getattr(state, m).state_dict().items()}
                    return steps[exploring].device_step, calls, params

                reports.append(cs.graph_case(torch, f"train_step_{program} {algo} pixels", train_build,
                                             cs.GRAPH_TIMED["train"], (0.0, 0.0), lambda key, calls: 0.0,
                                             eager_once=True))
                gc.collect()
                torch.cuda.empty_cache()

            def player_build(algo=algo, exploring=player_program == "exploring"):
                args, state, _, _, _, fam = p2e_setup(torch, np, algo, device)
                actor = getattr(state, fam.explore_actor if exploring else fam.actor)
                player = fam.player(state.world_model.encoder, state.world_model.rssm, actor, actions_dim=[2],
                                    stochastic_size=args.stochastic_size,
                                    discrete_size=getattr(args, "discrete_size", 0),
                                    recurrent_state_size=args.recurrent_state_size,
                                    is_continuous=algo == "p2e_dv1")
                gen = torch.Generator(device=device).manual_seed(5)
                with torch.no_grad():
                    st = player.init_states(1)
                rng = np.random.default_rng(13)
                calls = [(st, {"rgb": torch.from_numpy(rng.integers(0, 256, (1, 64, 64, 3), dtype=np.uint8))
                               .to(device).float() / 255.0 - 0.5}, player.draw_noise(1, gen, device),
                          torch.full((), e, device=device)) for e in (0.3, 0.0, 0.1)]

                def step(*a):
                    with torch.inference_mode():
                        return player.noisy_step(*a)
                return step, calls, dict

            reports.append(cs.graph_case(torch, f"player_step_{player_program} {algo} pixels", player_build,
                                         cs.GRAPH_TIMED["player"], (0.0, 0.0), eager_once=True))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    bad = [r["name"] for r in reports if not r["graphed_exact"]]
    if bad:
        raise RuntimeError(f"graphed P2E steps not bit for bit their eager selves: {bad}")
    return reports


def _finite(records: list[dict]) -> bool:
    return all(math.isfinite(v) for r in records for k, v in r.items()
               if k.startswith(("Loss/", "State/", "Grads/", "Rewards/intrinsic")))


def p2e_phase(cs, torch, np, run, device, smi: str) -> dict:
    """Phase 18: Plan2Explore on DreamerV2 and DreamerV1 on the card. (a)
    each run of P2E_RUNS through the CLI, counted on the device: the switch
    at step P2E_SWITCH with one zero-shot episode, both programs' gradient
    and player steps graph replays after their first calls, no fallback,
    losses finite, every trained module moved, no port kernel launched (the
    guards refuse every module of both paths); resumed from its checkpoint
    at P2E_RESUME, after the switch, with its buffer: the task program
    only, then the task actor's test episodes; (b) one exploring step of
    each on the card against the CPU; (c) each graphed step against its
    eager self, bit for bit, timed. Raises on any failure. -> the phase's
    report."""
    out: dict = {"smi": smi}
    parts: dict[str, float] = {}
    root = os.path.join(cs.OUT_DIR, "p2e_logs")
    cs.shutil.rmtree(root, ignore_errors=True)
    for tag, argv in P2E_RUNS.items():
        gc.collect()
        torch.cuda.empty_cache()
        name = tag.replace(" ", "_")
        t0 = time.perf_counter()
        run_dir = os.path.join(root, name)
        launches, wrapper, done = cs.drive_dreamer(torch, run, [*argv, "--root_dir", root, "--run_name", name], run_dir)
        parts[tag] = time.perf_counter() - t0
        with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
            records = [r for r in (json.loads(line) for line in fh if line.strip()) if "gradient_steps" in r
                       and "event" not in r]
        finite = _finite(records)
        moved = {k[len("Params/"):-len("_delta")]: v for k, v in done.items() if k.startswith("Params/")}
        calls = done["graph_calls"]
        step_ms = sorted(done["train_step_ms"][1:])
        cs.log(f"[p2e] {tag}: {' '.join(argv)}: {done['gradient_steps']} gradient steps ({calls}), "
               f"{done['player_steps']} player steps, {done['env_steps']} env steps in {parts[tag]:.1f} s; switch at "
               f"step {done['exploration_updates']}, zero-shot {done['zero_shot']}; losses finite {finite}; parameter "
               f"change (L2) {moved}; host wall a gradient step median "
               f"{step_ms[len(step_ms) // 2] if step_ms else float('nan'):.2f} ms; port kernels on the device "
               f"{sum(launches.values())} ({ {k: n for k, n in launches.items() if n} }), by the wrappers "
               f"{sum(wrapper.values())}; {cs.fmt_tests(done)}; graphs: {cs.check_graphs(done, tag, steps=calls)}")
        if (done["exploration_updates"] != P2E_SWITCH or (done["zero_shot"] or {}).get("step") != P2E_SWITCH
                or min(calls.get(k, 0) for k in ("train_step_exploring", "train_step_task", "player_step_exploring",
                                                 "player_step_task")) < 2
                or not finite or min(moved.values()) <= 0):
            raise RuntimeError(f"{tag}: no switch in the run, a program not replayed, a loss not finite or a module "
                               f"unmoved: {calls} {done['zero_shot']} {moved}")
        if any(launches.values()) or any(wrapper.values()):
            raise RuntimeError(f"{tag}: a port kernel launched on a path whose guards refuse them all: "
                               f"{launches} {wrapper}")
        out[tag] = dict(argv=argv, done=done, records=records, launches=launches, wrapper_launches=wrapper)
        ckpt = os.path.join(run_dir, "checkpoints", f"ckpt_{P2E_RESUME}")
        t0 = time.perf_counter()
        launches, wrapper, rdone = cs.drive_dreamer(torch, run, [argv[0], "--checkpoint_path", ckpt], run_dir)
        parts[f"{tag} resume"] = time.perf_counter() - t0
        rcalls = rdone["graph_calls"]
        cs.log(f"[p2e] {tag} resumed from {ckpt}: {rdone['resumed']}, {rdone['gradient_steps']} gradient steps "
               f"({rcalls}), {rdone['player_steps']} player steps; port kernels on the device "
               f"{sum(launches.values())}; {cs.fmt_tests(rdone)} (the task actor); graphs: "
               f"{cs.check_graphs(rdone, tag + ' resume', steps=rcalls)}")
        if rdone["resumed"]["start_step"] != P2E_RESUME + 1 or "buffer" not in rdone["resumed"] \
                or rdone["resumed"]["exploring"] or set(rcalls) != {"train_step_task", "player_step_task"} \
                or any(launches.values()) or any(wrapper.values()) or not rdone["test_returns"]:
            raise RuntimeError(f"{tag}: the resume did not keep the task program from its checkpoint: {rdone}")
        out[f"{tag} resume"] = dict(done=rdone, launches=launches)

    t0 = time.perf_counter()
    for algo in ("p2e_dv2", "p2e_dv1"):
        check = card_cpu_check(cs, torch, np, algo, device)
        out[f"{algo} card_cpu"] = check
        cs.log(f"[p2e] {algo}: one exploring step (default widths, B {P2E_CPU_BATCH}) card vs CPU: "
               + ", ".join(f"{k.split('/')[1]} {check['card'][k]:.6g}/{check['cpu'][k]:.6g}" for k in check["cpu"])
               + f"; parameter gap over its tolerance {check['param_err']}; card {check['card_seconds']:.2f} s, "
               f"CPU {check['cpu_seconds']:.2f} s")
        if check["metric_bad"] or max(check["param_err"].values()) > 1.0:
            raise RuntimeError(f"{algo}: the card's exploring step disagrees with the CPU's: {check['metric_bad']} "
                               f"{check['param_err']}")
    parts["card vs cpu"] = time.perf_counter() - t0
    _TEMPLATES.clear()

    t0 = time.perf_counter()
    out["graphs"] = graph_cases(cs, torch, np, device)
    parts["graphs"] = time.perf_counter() - t0
    _TEMPLATES.clear()
    out["seconds"] = parts
    cs.log(f"[p2e] {smi}: the phase's parts (s): " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
           + f"; {sum(parts.values()):.1f} in all")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(HERE, "build", "p2e_phase"),
                        help="directory for the report and the runs' logs")
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_p2e_phase: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.ops.kernels import build

    cs.OUT_DIR = os.path.abspath(args.out)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    gc.callbacks.append(cs.GC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    smi = cs.smi_line()
    out = p2e_phase(cs, torch, np, run, torch.device("cuda"), smi)
    with open(os.path.join(cs.OUT_DIR, "p2e.json"), "w") as fh:
        json.dump(out, fh, default=str)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
