"""Evaluation in the port (`utils/evaluation.py`, the parser's
`_cli_provided`, DreamerV3's `--eval_only` and end-of-run test episodes)
against the reference's `sheeprl_tpu/utils/evaluation.py` and parser:

  - the parser records the same explicitly given flags as the reference's
    on the same argv lists (`--flag=value`, `--no_flag`, lists, `@file`);
  - `apply_eval_overrides` merges the same dict as the reference's over a
    grid of eval-only / resume runs and given flags, the reference's
    `platform` read as the port's `device` (its `num_devices` has no
    counterpart);
  - `validate_eval_args` and `run_test_episodes` (seeds base + i, the seed
    restored, the records) behave as the reference's;
  - a tiny DreamerV3 resumed with a larger `--total_steps` trains on to it,
    a checkpoint whose sidecar says `cuda` evaluates and resumes with
    `--device cpu`, `--eval_only` plays its episodes without a gradient
    step and leaves the parameters as the file holds them.
"""

from __future__ import annotations

import json
import os
import types

import pytest
import torch

# the port's tiny DreamerV3 run on the CPU (README)
PORT_TINY = [
    "--device", "cpu", "--env_id", "discrete_dummy", "--cnn_keys", "rgb", "--num_envs", "1",
    "--cnn_channels_multiplier", "2", "--dense_units", "16", "--hidden_size", "16", "--recurrent_state_size", "16",
    "--stochastic_size", "4", "--discrete_size", "4", "--per_rank_batch_size", "2", "--per_rank_sequence_length",
    "4", "--horizon", "3", "--train_every", "2", "--buffer_size", "64", "--bins", "15", "--learning_starts", "16",
]

ARGV_CASES = {
    "none": [],
    "one": ["--total_steps", "40"],
    "equals_and_no": ["--total_steps=40", "--no_checkpoint_buffer", "--seed", "3"],
    "bool_and_list": ["--checkpoint_buffer", "--cnn_keys", "rgb", "state", "--eval_only"],
    "defaults_given": ["--seed", "42", "--checkpoint_path", "p", "--test_episodes", "1"],
    "argfile": ["@ARGFILE", "--run_name", "r"],
}


@pytest.mark.parametrize("case", sorted(ARGV_CASES))
def test_cli_provided_matches_the_reference(case, tmp_path):
    """A flag counts as given when the command line names it, even at its
    default value; through `@file` expansion too."""
    from sheeprl_tpu.algos.dreamer_v3.args import DreamerV3Args as RefArgs
    from sheeprl_tpu.utils.parser import DataclassArgumentParser as RefParser
    from sheeprl_tpu_torch.algos.dreamer_v3.args import DreamerV3Args
    from sheeprl_tpu_torch.utils.parser import DataclassArgumentParser

    argfile = tmp_path / "run.args"
    argfile.write_text("--total_steps\n64\n--no_expl_decay\n")
    argv = [f"@{argfile}" if a == "@ARGFILE" else a for a in ARGV_CASES[case]]
    (ref,) = RefParser(RefArgs).parse_args_into_dataclasses(argv)
    (port,) = DataclassArgumentParser(DreamerV3Args).parse_args_into_dataclasses(argv)
    assert port._cli_provided == ref._cli_provided
    named = {a.lstrip("-").split("=")[0].removeprefix("no_") for a in argv if a.startswith("--")}
    assert port._cli_provided == named | ({"total_steps", "expl_decay"} if case == "argfile" else set())


# a checkpoint's sidecar (the fields both packages have) and a command line
SIDECAR = dict(seed=42, root_dir="train_root", run_name="train_run", test_episodes=1, total_steps=24,
               eval_only=False, checkpoint_path=None, device="cuda", learning_starts=16)
CLI = dict(seed=7, root_dir="eval_root", run_name="eval_run", test_episodes=3, total_steps=40,
           checkpoint_path="ckpt", device="cpu", learning_starts=8)
PROVIDED = {
    "nothing": set(),
    "budget": {"total_steps"},
    "device": {"device"},
    "targets": {"seed", "root_dir", "run_name", "test_episodes"},
    "everything": set(CLI),
}


@pytest.mark.parametrize("provided", sorted(PROVIDED))
@pytest.mark.parametrize("eval_only", [True, False], ids=["eval_only", "resume"])
def test_apply_eval_overrides_matches_the_reference(eval_only, provided):
    from sheeprl_tpu.utils.evaluation import apply_eval_overrides as ref_apply
    from sheeprl_tpu_torch.utils.evaluation import apply_eval_overrides

    def to_ref(d: dict) -> dict:
        return {("platform" if k == "device" else k): v for k, v in d.items()}

    given = PROVIDED[provided]
    port_args = types.SimpleNamespace(**CLI, eval_only=eval_only, _cli_provided=set(given))
    ref_args = types.SimpleNamespace(**to_ref(CLI), num_devices=1, eval_only=eval_only,
                                     _cli_provided={"platform" if f == "device" else f for f in given})
    port = apply_eval_overrides(dict(SIDECAR), port_args)
    ref = ref_apply({**to_ref(SIDECAR), "num_devices": -1}, ref_args)
    # the reference's num_devices (all local devices when -1) has no
    # counterpart in the port; everything else must agree
    ref.pop("num_devices")
    assert port == {("device" if k == "platform" else k): v for k, v in ref.items()}
    if eval_only:
        assert (port["device"], port["seed"], port["root_dir"], port["run_name"], port["test_episodes"]) == (
            "cpu", 7, "eval_root", "eval_run", 3)
        assert port["total_steps"] == 24 and port["eval_only"] is True
    else:
        assert port["total_steps"] == (40 if "total_steps" in given else 24)
        assert port["device"] == ("cpu" if "device" in given else "cuda")
        assert port["checkpoint_path"] is None  # the caller sets it


@pytest.mark.parametrize("eval_only,path,raises", [(True, None, True), (True, "p", False), (False, None, False)])
def test_validate_eval_args_matches_the_reference(eval_only, path, raises):
    from sheeprl_tpu.utils.evaluation import validate_eval_args as ref_validate
    from sheeprl_tpu_torch.utils.evaluation import validate_eval_args

    args = types.SimpleNamespace(eval_only=eval_only, checkpoint_path=path)
    for fn in (ref_validate, validate_eval_args):
        if raises:
            with pytest.raises(ValueError, match="--eval_only requires --checkpoint_path"):
                fn(args)
        else:
            fn(args)


class _Logger:
    def __init__(self):
        self.calls = []

    def log(self, name, value, step):
        self.calls.append((name, value, step))


@pytest.mark.parametrize("episodes", [0, 1, 3])
def test_run_test_episodes_matches_the_reference(episodes):
    """Episode i runs at seed base + i; the seed is restored, also when an
    episode raises; each return is logged and, past one episode, the mean."""
    from sheeprl_tpu.utils.evaluation import run_test_episodes as ref_run
    from sheeprl_tpu_torch.utils.evaluation import run_test_episodes

    results = []
    for fn in (ref_run, run_test_episodes):
        args, logger, seeds = types.SimpleNamespace(seed=100, test_episodes=episodes), _Logger(), []

        def episode():
            seeds.append(args.seed)
            return float(args.seed) / 10

        rets = fn(episode, args, logger)
        assert args.seed == 100
        results.append((rets, seeds, logger.calls))

        def broken():
            raise RuntimeError("env failed")

        with pytest.raises(RuntimeError, match="env failed"):
            fn(broken, args, logger)
        assert args.seed == 100
    assert results[0] == results[1]
    rets, seeds, calls = results[1]
    n = max(episodes, 1)
    assert seeds == [100 + i for i in range(n)]
    assert [c[0] for c in calls] == ["Test/episode_reward"] * n + (["Test/mean_reward"] if n > 1 else [])


# ---------------------------------------------------------------------------
# DreamerV3's main: resume with explicit flags, and --eval_only
# ---------------------------------------------------------------------------


def _records(run_dir: str) -> list[dict]:
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny DreamerV3 run on the CPU with checkpoints at steps 8, 16 and
    24. -> its run directory."""
    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main

    root = tmp_path_factory.mktemp("dv3")
    main(PORT_TINY + ["--total_steps", "24", "--checkpoint_every", "8", "--root_dir", str(root), "--run_name", "r"])
    return str(root / "r")


@pytest.mark.timeout(300)
def test_resume_with_a_larger_budget_trains_on_to_it(tiny_run, tmp_path):
    """`--checkpoint_path .../ckpt_16 --total_steps 40` trains to step 40 and
    writes its checkpoints there, as the reference does: the command line's
    explicit flags override the sidecar."""
    import shutil

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main
    from sheeprl_tpu_torch.utils.checkpoint import list_checkpoints

    run_dir = str(tmp_path / "r")
    shutil.copytree(tiny_run, run_dir)
    main(["--checkpoint_path", os.path.join(run_dir, "checkpoints", "ckpt_16"), "--total_steps", "40"])
    done = [r for r in _records(run_dir) if r.get("event") == "done"][-1]
    assert done["resumed"]["start_step"] == 17 and done["env_steps"] == 40 - 16 and done["policy_steps"] == 40
    assert done["gradient_steps"] > 0 and [c["step"] for c in done["checkpoints"]] == [24, 32, 40]
    assert os.path.basename(list_checkpoints(os.path.join(run_dir, "checkpoints"))[0]) == "ckpt_40"
    with open(os.path.join(run_dir, "checkpoints", "ckpt_40.args.json")) as fh:
        assert json.load(fh)["total_steps"] == 40


@pytest.mark.timeout(300)
def test_checkpoint_written_for_cuda_evaluates_and_resumes_on_the_cpu(tiny_run, tmp_path):
    """A sidecar that says `cuda` (a checkpoint written on the card) is
    evaluated and resumed with `--device cpu`: the command line's device
    wins over the sidecar's."""
    import shutil

    from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import main

    run_dir = str(tmp_path / "r")
    shutil.copytree(tiny_run, run_dir)
    ckpt = os.path.join(run_dir, "checkpoints", "ckpt_16")
    with open(ckpt + ".args.json") as fh:
        cfg = json.load(fh)
    cfg["device"] = "cuda"
    with open(ckpt + ".args.json", "w") as fh:
        json.dump(cfg, fh)
    main(["--eval_only", "--checkpoint_path", ckpt, "--device", "cpu"])
    main(["--checkpoint_path", ckpt, "--device", "cpu"])
    evaluated, resumed = [r for r in _records(run_dir) if r.get("event") == "done"][-2:]
    assert evaluated["device"] == resumed["device"] == "cpu"
    assert evaluated["gradient_steps"] == 0 and len(evaluated["test_returns"]) == 1
    assert resumed["resumed"]["start_step"] == 17 and resumed["env_steps"] == 24 - 16


@pytest.mark.timeout(300)
def test_eval_only_plays_its_episodes_and_leaves_the_parameters(tiny_run, tmp_path):
    """`--eval_only --test_episodes 2` over a port checkpoint: two episodes
    at seeds 1000 and 1001 with the reference's records, no gradient step,
    no checkpoint, the restored parameters unmoved; it logs into its own
    `--root_dir`, and without one into the checkpoint's run directory under
    `eval_args.json`, leaving the run's `args.json`."""
    import shutil

    from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    run_dir = str(tmp_path / "r")
    shutil.copytree(tiny_run, run_dir)
    ckpt = os.path.join(run_dir, "checkpoints", "ckpt_24")
    with open(os.path.join(run_dir, "args.json")) as fh:
        train_args = fh.read()
    seeds = []
    real_test = dv3.test

    def spy(player, logger, args, *a, **k):
        seeds.append(args.seed)
        # the restored parameters at each episode equal the checkpoint's
        saved = load_checkpoint(ckpt)
        for name, p in player.actor.state_dict().items():
            assert torch.equal(p, saved["actor"][name]), name
        for name, p in player.rssm.state_dict().items():
            assert torch.equal(p, saved["world_model"][f"rssm.{name}"]), name
        return real_test(player, logger, args, *a, **k)

    dv3.test = spy
    try:
        dv3.main(["--eval_only", "--checkpoint_path", ckpt, "--test_episodes", "2", "--seed", "1000",
                  "--root_dir", str(tmp_path / "eval"), "--run_name", "e", "--device", "cpu"])
        dv3.main(["--eval_only", "--checkpoint_path", ckpt, "--device", "cpu"])
    finally:
        dv3.test = real_test
    assert seeds == [1000, 1001, 42]
    eval_dir = str(tmp_path / "eval" / "e")
    records = _records(eval_dir)
    done = records[-1]
    assert done["event"] == "done" and done["gradient_steps"] == 0 and done["player_steps"] == 0
    assert done["checkpoints"] == [] and len(done["test_returns"]) == 2 and len(done["test_player_steps"]) == 2
    assert all(done[f"Params/{m}_delta"] == 0.0 for m in ("world_model", "actor", "critic"))
    names = [k for r in records[:-1] for k in r if k.startswith("Test/")]
    assert names == ["Test/cumulative_reward", "Test/episode_reward"] * 2 + ["Test/mean_reward"]
    assert os.path.exists(os.path.join(eval_dir, "eval_args.json"))
    assert not os.path.exists(os.path.join(eval_dir, "args.json"))
    with open(os.path.join(eval_dir, "eval_args.json")) as fh:
        assert json.load(fh)["eval_only"] is True
    # without --root_dir: the checkpoint's run directory, its args.json kept
    with open(os.path.join(run_dir, "args.json")) as fh:
        assert fh.read() == train_args
    assert os.path.exists(os.path.join(run_dir, "eval_args.json"))
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == sorted(os.listdir(
        os.path.join(tiny_run, "checkpoints")))


@pytest.mark.parametrize("task", ["dreamer_v3", "ppo"])
def test_eval_only_without_a_checkpoint_raises_before_any_env(task, monkeypatch):
    import importlib

    from sheeprl_tpu_torch.cli import run

    module = importlib.import_module(f"sheeprl_tpu_torch.algos.{task}.{task}")

    def no_env(*a, **k):
        raise AssertionError("an env was built")

    monkeypatch.setattr(module, "make_dict_env", no_env)
    with pytest.raises(ValueError, match="--eval_only requires --checkpoint_path"):
        run([task, "--eval_only", "--device", "cpu"])
