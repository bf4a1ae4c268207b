"""SAC training in the port (`algos/sac/`: the critic ensemble, the losses,
`make_train_step`, `main`; `interop.sac_checkpoint_from_jax`) against the
reference `sheeprl_tpu` on the CPU, at small sizes (obs 3, act 1, width
16, 2 critics), with inputs made from seeds by numpy and the reference's
parameters carried across:

  - the critic ensemble's forward `[B, n]` at atol 1e-6 (f32);
  - the three losses at 1e-6;
  - one `make_train_step` call at G = 2, B = 8, with the actor's noise
    rebuilt from the reference's key tree (`split(key, G)`, then
    `split(k)`: the target's, the actor's), EMA on and off: every
    parameter of the actor, the critics and the target critics,
    `log_alpha`, the three Adam states and the three losses, at atol 2e-6
    in f32 (each Adam step moves a parameter by about lr = 3e-4 whatever
    the gradient's size, so the float differences of the two backward
    passes show only through `eps`), and in bf16 at atol 3e-3 for
    parameters (bf16 forwards and backwards, f32 masters) and rtol 3e-2
    for the losses;
  - the same step through `CompilePlan(mode="static")` (the graph's copy-in
    and copy-out without a graph) against direct calls, bit for bit;
  - `sac --device cpu` at tiny widths: the checkpoint's keys (the
    reference's contract plus `generator`), a resume at `global_step + 1`
    with and without `--checkpoint_buffer` (without it, the re-collection
    and the catch-up burst), `--eval_only`, and `serve --algo sac --ckpt`
    answering with the trained actor's greedy actions;
  - a reference checkpoint (its `sac` main, `--dry_run`) carried by
    `sac_checkpoint_from_jax` into the port's agent and Adams, bit for bit.
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_interop import jax_flat

OBS, ACT, HIDDEN, N_CRITICS = 3, 1, 16, 2
G, B = 2, 8


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def ref_agent(cls_name: str = "sac", precision: str = "float32", seed: int = 0, **kw):
    if cls_name == "sac":
        from sheeprl_tpu.algos.sac.agent import SACAgent as Cls
    else:
        from sheeprl_tpu.algos.droq.agent import DROQAgent as Cls
    return Cls.init(jax.random.PRNGKey(seed), OBS, ACT, num_critics=N_CRITICS, actor_hidden_size=HIDDEN,
                    critic_hidden_size=HIDDEN, action_low=np.full(ACT, -2.0, np.float32),
                    action_high=np.full(ACT, 2.0, np.float32), alpha=0.5, tau=0.05,
                    precision=precision, **kw)


def port_agent(ref, cls_name: str = "sac", precision: str = "float32", **kw):
    """The port's agent holding `ref`'s parameters."""
    from sheeprl_tpu_torch.algos.droq.agent import DROQAgent
    from sheeprl_tpu_torch.algos.sac.agent import SACAgent
    from sheeprl_tpu_torch.interop import load_jax_params

    cls = SACAgent if cls_name == "sac" else DROQAgent
    agent = cls(OBS, ACT, num_critics=N_CRITICS, actor_hidden_size=HIDDEN, critic_hidden_size=HIDDEN,
                action_low=-2.0, action_high=2.0, alpha=0.5, tau=0.05, precision=precision, **kw)
    for name in ("actor", "critics", "target_critics"):
        load_jax_params(getattr(agent, name), jax_flat(getattr(ref, name)))
    with torch.no_grad():
        agent.log_alpha.copy_(_t(ref.log_alpha))
    return agent


def batch(seed: int = 1, lead=(G, B)) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "observations": rng.normal(size=(*lead, OBS)).astype(np.float32),
        "next_observations": rng.normal(size=(*lead, OBS)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (*lead, ACT)).astype(np.float32),
        "rewards": rng.normal(size=(*lead, 1)).astype(np.float32),
        "dones": (rng.random((*lead, 1)) < 0.25).astype(np.float32),
    }


def adam_of(opt_state) -> dict:
    """The reference's live optax state -> {count, mu, nu} with flat paths
    (mu and nu as one array for a bare leaf such as `log_alpha`)."""
    state = next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                 if hasattr(s, "mu"))
    flat = (lambda t: np.asarray(t)) if isinstance(state.mu, jax.Array) else jax_flat
    return {"count": np.asarray(state.count), "mu": flat(state.mu), "nu": flat(state.nu)}


def assert_agents_match(port, ref, atol: float, rtol: float = 0.0) -> None:
    from sheeprl_tpu_torch.nn.layers import Linear

    for name in ("actor", "critics", "target_critics"):
        module = getattr(port, name)
        linear = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, Linear)}
        want = jax_flat(getattr(ref, name))
        for path, p in module.state_dict().items():
            w = want[path].T if path in linear else want[path]
            np.testing.assert_allclose(p.float().numpy(), w, atol=atol, rtol=rtol, err_msg=f"{name}.{path}")
    np.testing.assert_allclose(port.log_alpha.detach().numpy(), np.asarray(ref.log_alpha), atol=atol, rtol=rtol)


def assert_adams_match(port_state, ref_state, atol: float, rtol: float = 0.0) -> None:
    """Each port Adam's step counts and moments against the reference's
    optax state of the same module."""
    from sheeprl_tpu_torch.nn.layers import Linear

    pairs = (("critics", port_state.qf_opt, ref_state.qf_opt), ("actor", port_state.actor_opt, ref_state.actor_opt),
             ("log_alpha", port_state.alpha_opt, ref_state.alpha_opt))
    for name, opt, ref_opt in pairs:
        want = adam_of(ref_opt)
        if name == "log_alpha":
            named = {"": port_state.agent.log_alpha}
            want = {**want, "mu": {"": want["mu"]}, "nu": {"": want["nu"]}}
            linear = set()
        else:
            module = getattr(port_state.agent, name)
            named = dict(module.named_parameters())
            linear = {f"{n}.weight" for n, m in module.named_modules() if isinstance(m, Linear)}
        for path, p in named.items():
            st = opt.state[p]
            assert float(st["step"]) == float(want["count"]), name
            tr = (lambda a: a.T) if path in linear else (lambda a: a)
            for key, side in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                np.testing.assert_allclose(st[key].numpy(), tr(want[side][path]), atol=atol, rtol=rtol,
                                           err_msg=f"{name}.{path} {key}")


# ---------------------------------------------------------------------------
# the ensemble and the losses
# ---------------------------------------------------------------------------


def test_critic_ensemble_matches_the_reference():
    ref = ref_agent()
    port = port_agent(ref)
    data = batch(lead=(32,))
    want = np.asarray(ref.critics(jnp.asarray(data["observations"]), jnp.asarray(data["actions"])))
    with torch.no_grad():
        got = port.critics(_t(data["observations"]), _t(data["actions"])).numpy()
    assert got.shape == (32, N_CRITICS)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the stacked weights keep the reference's [n, in, out] layout
    assert tuple(port.critics.members.model.layers[0].weight.shape) == (N_CRITICS, OBS + ACT, HIDDEN)


def test_losses_match_the_reference():
    from sheeprl_tpu.algos.sac import loss as ref
    from sheeprl_tpu_torch.algos.sac import loss

    rng = np.random.default_rng(5)
    q, y, logp = (rng.normal(size=s).astype(np.float32) for s in ((16, N_CRITICS), (16, 1), (16, 1)))
    log_alpha = np.array([-0.3], np.float32)
    pairs = [
        (loss.critic_loss(_t(q), _t(y)), ref.critic_loss(jnp.asarray(q), jnp.asarray(y))),
        (loss.policy_loss(_t(np.exp(log_alpha)), _t(logp), _t(q[:, :1])),
         ref.policy_loss(jnp.exp(log_alpha), jnp.asarray(logp), jnp.asarray(q[:, :1]))),
        (loss.entropy_loss(_t(log_alpha), _t(logp), -1.0), ref.entropy_loss(jnp.asarray(log_alpha), jnp.asarray(logp), -1.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------


def sac_noise(key, g: int, b: int) -> dict[str, np.ndarray]:
    """The normals of the reference's SAC step (sac.py:139-141, :88-90)."""
    target, actor = [], []
    for k in jax.random.split(key, g):
        k_target, k_actor = jax.random.split(k)
        target.append(np.asarray(jax.random.normal(k_target, (b, ACT), jnp.float32)))
        actor.append(np.asarray(jax.random.normal(k_actor, (b, ACT), jnp.float32)))
    return {"target": np.stack(target), "actor": np.stack(actor)}


def _sac_args(precision: str):
    from sheeprl_tpu.algos.sac.args import SACArgs as RefArgs
    from sheeprl_tpu_torch.algos.sac.args import SACArgs

    kw = dict(gradient_steps=G, per_rank_batch_size=B, num_critics=N_CRITICS, actor_hidden_size=HIDDEN,
              critic_hidden_size=HIDDEN, gamma=0.97, precision=precision)
    return RefArgs(**kw), SACArgs(**kw, device="cpu")


def _ref_sac_step(precision: str, do_ema: bool, key_seed: int = 7):
    from sheeprl_tpu.algos.sac.sac import TrainState, make_optimizers, make_train_step

    ref_args, args = _sac_args(precision)
    ref = ref_agent(precision=precision)
    port = port_agent(ref, precision=precision)
    qf, actor, alpha = make_optimizers(ref_args)
    state = TrainState(agent=ref, qf_opt=qf.init(ref.critics), actor_opt=actor.init(ref.actor),
                       alpha_opt=alpha.init(ref.log_alpha))
    data = batch()
    key = jax.random.PRNGKey(key_seed)
    new_state, metrics = make_train_step(ref_args, qf, actor, alpha)(
        state, {k: jnp.asarray(v) for k, v in data.items()}, key, jnp.asarray(do_ema))
    return args, port, data, sac_noise(key, G, B), new_state, metrics


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("do_ema", [True, False], ids=["ema", "no_ema"])
def test_one_train_step_matches_the_reference(precision, do_ema):
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainState, make_optimizers, make_train_step, sac_draws

    args, port, data, noise, ref_state, metrics = _ref_sac_step(precision, do_ema)
    before = {k: v.clone() for k, v in port.target_critics.state_dict().items()}
    state = SACTrainState(port, *make_optimizers(args, port))
    layout = sac_draws(args, ACT)
    losses = make_train_step(args, layout)(state, {k: _t(v) for k, v in data.items()}, layout.pack(noise),
                                           torch.tensor(do_ema))
    f32 = precision == "float32"
    atol, rtol = (2e-6, 0.0) if f32 else (3e-3, 0.0)
    assert_agents_match(port, ref_state.agent, atol=atol)
    assert_adams_match(state, ref_state, atol=1e-6 if f32 else 3e-3, rtol=1e-4 if f32 else 3e-2)
    want = [float(metrics[k]) for k in ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")]
    np.testing.assert_allclose(losses.numpy(), want, rtol=1e-5 if f32 else 3e-2, atol=1e-6 if f32 else 3e-3)
    if not do_ema:  # the gate held the targets
        for k, v in port.target_critics.state_dict().items():
            assert torch.equal(v, before[k]), k


def test_static_train_step_equals_direct_calls():
    """The step through the plan's copy machinery (`mode="static"`) against
    the same step called directly, over three calls with fresh inputs and
    both EMA gates: losses and every parameter bit for bit."""
    import copy

    from sheeprl_tpu_torch.algos.sac.sac import SACTrainState, make_optimizers, make_train_step, sac_draws
    from sheeprl_tpu_torch.compile.plan import CompilePlan

    args = _sac_args("float32")[1]
    direct_agent = port_agent(ref_agent())
    static_agent = copy.deepcopy(direct_agent)
    layout = sac_draws(args, ACT)
    step = make_train_step(args, layout)
    direct = SACTrainState(direct_agent, *make_optimizers(args, direct_agent))
    static = SACTrainState(static_agent, *make_optimizers(args, static_agent))
    wj = CompilePlan(mode="static").register("train_step", step, role="update")
    gen = torch.Generator().manual_seed(3)
    for i in range(3):
        data = {k: _t(v) for k, v in batch(seed=10 + i).items()}
        draws = layout.fill(layout.new("cpu"), gen)
        gate = torch.tensor(i != 1)
        got = wj(static, data, draws, gate).clone()
        assert torch.equal(got, step(direct, data, draws, gate))
    for a, b in zip(static_agent.state_dict().values(), direct_agent.state_dict().values()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--num_envs", "1", "--actor_hidden_size", "8", "--critic_hidden_size", "8",
        "--per_rank_batch_size", "8", "--learning_starts", "16", "--buffer_size", "128"]


def done_record(run_dir: str) -> dict:
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        return [json.loads(line) for line in fh][-1]


@pytest.fixture(scope="module")
def sac_run(tmp_path_factory):
    """A tiny SAC run of 64 steps with checkpoints and buffers at 32 and 64.
    -> its run directory."""
    from sheeprl_tpu_torch.cli import run

    root = tmp_path_factory.mktemp("sac")
    run(["sac", *TINY, "--total_steps", "64", "--checkpoint_every", "32", "--checkpoint_buffer",
         "--root_dir", str(root), "--run_name", "r"])
    return str(root / "r")


def test_sac_cli_checkpoints_carry_the_reference_keys(sac_run):
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint, load_checkpoint_args

    rec = done_record(sac_run)
    assert rec["event"] == "done" and rec["env_steps"] == 64
    # one train step a step from learning_starts - 1 = 15 on, 16 at the burst
    assert rec["train_calls"] == 16 + (64 - 15) and rec["gradient_steps"] == rec["train_calls"]
    assert [c["step"] for c in rec["checkpoints"]] == [32, 64]
    ckpt = load_checkpoint(os.path.join(sac_run, "checkpoints", "ckpt_64"))
    assert set(ckpt) == {"agent", "qf_optimizer", "actor_optimizer", "alpha_optimizer", "global_step", "generator"}
    assert set(ckpt["agent"]) == {"actor", "critics", "target_critics", "log_alpha"}
    assert ckpt["global_step"] == 64
    assert "members.model.layers.0.weight" in ckpt["agent"]["critics"]
    assert load_checkpoint_args(os.path.join(sac_run, "checkpoints", "ckpt_64"))["critic_hidden_size"] == 8
    assert os.path.exists(os.path.join(sac_run, "checkpoints", "ckpt_32.buffer.npz"))
    for ret in rec["test_returns"]:
        assert np.isfinite(ret)
    losses = [r for r in map(json.loads, open(os.path.join(sac_run, "metrics.jsonl"))) if "Loss/value_loss" in r]
    assert losses and all(np.isfinite(r["Loss/value_loss"]) for r in losses)


@pytest.mark.parametrize("with_buffer", [True, False], ids=["buffer", "no_buffer"])
def test_sac_cli_resumes_after_the_checkpoint(sac_run, tmp_path, with_buffer):
    import shutil

    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint

    run_dir = str(tmp_path / "r")
    shutil.copytree(sac_run, run_dir)
    ckpt = os.path.join(run_dir, "checkpoints", "ckpt_32")
    if not with_buffer:
        os.remove(ckpt + ".buffer.npz")
    run(["sac", "--checkpoint_path", ckpt, "--device", "cpu"])
    rec = done_record(run_dir)
    assert rec["resumed"]["start_step"] == 33 and rec["resumed"]["buffer"] is with_buffer
    assert rec["env_steps"] == 32
    # with the buffer every step trains; without it the run re-collects to
    # step 48 = learning_starts + 33 - 1 and bursts 16 train steps there
    assert rec["train_calls"] == 32 if with_buffer else 16 + (64 - 47)
    assert rec["burst_s"] > 0 if not with_buffer else rec["burst_s"] == 0
    assert load_checkpoint(os.path.join(run_dir, "checkpoints", "ckpt_64"))["global_step"] == 64


def test_sac_cli_eval_only_and_serve_ckpt(sac_run, tmp_path):
    from sheeprl_tpu_torch.algos.sac.agent import SACActor
    from sheeprl_tpu_torch.cli import run
    from sheeprl_tpu_torch.serve.client import ServeClient
    from sheeprl_tpu_torch.utils.checkpoint import load_checkpoint
    from tests.test_torch_checkpoint import _serve

    ckpt = os.path.join(sac_run, "checkpoints", "ckpt_64")
    before = load_checkpoint(ckpt)
    run(["sac", "--eval_only", "--checkpoint_path", ckpt, "--test_episodes", "2", "--seed", "1000", "--device",
         "cpu", "--root_dir", str(tmp_path), "--run_name", "e"])
    rec = done_record(str(tmp_path / "e"))
    assert rec["train_calls"] == 0 and len(rec["test_returns"]) == 2
    after = load_checkpoint(ckpt)
    assert all(torch.equal(a, b) for a, b in zip(before["agent"]["actor"].values(), after["agent"]["actor"].values()))

    actor = SACActor(3, 1, hidden_size=8, action_low=-2.0, action_high=2.0)
    actor.load_state_dict(before["agent"]["actor"])
    obs = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    address, thread, errors = _serve(["--device", "cpu", "--algo", "sac", "--ckpt", ckpt, "--root_dir",
                                      str(tmp_path), "--run_name", "s", "--serve_requests", "4",
                                      "--deadline_ms", "0"], str(tmp_path / "s"))
    with ServeClient(address) as client:
        answers = [client.request({"obs": obs[i:i + 1]}) for i in range(4)]
    thread.join(timeout=60)
    assert not thread.is_alive() and not errors, errors
    with torch.no_grad():
        want = actor.get_greedy_actions(torch.from_numpy(obs)).numpy()
    for i, (res, _meta) in enumerate(answers):
        np.testing.assert_allclose(res["actions"], want[i:i + 1], atol=1e-6, rtol=0)


def test_reference_sac_checkpoint_carries_into_the_port(tmp_path):
    import sheeprl_tpu.algos  # noqa: F401 - registers the tasks
    from sheeprl_tpu.utils.checkpoint import load_checkpoint as ref_load
    from sheeprl_tpu.utils.registry import tasks
    from sheeprl_tpu_torch.algos.sac.agent import SACAgent
    from sheeprl_tpu_torch.algos.sac.args import SACArgs
    from sheeprl_tpu_torch.algos.sac.sac import SACTrainState, make_optimizers, restore_state
    from sheeprl_tpu_torch.interop import flatten_params, sac_checkpoint_from_jax

    tasks["sac"](["--env_id", "Pendulum-v1", "--dry_run", "--num_envs", "1", "--per_rank_batch_size", "2",
                  "--buffer_size", "4", "--learning_starts", "0", "--gradient_steps", "1", "--actor_hidden_size",
                  "8", "--critic_hidden_size", "8", "--root_dir", str(tmp_path), "--run_name", "ref"])
    raw = ref_load(str(tmp_path / "ref" / "checkpoints" / "ckpt_1"))
    agent = SACAgent(3, 1, actor_hidden_size=8, critic_hidden_size=8, action_low=-2.0, action_high=2.0)
    state = SACTrainState(agent, *make_optimizers(SACArgs(), agent))
    restore_state(state, sac_checkpoint_from_jax(raw, state))
    want = flatten_params(raw["agent"]["critics"])
    for path, p in agent.critics.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), want[path])
    np.testing.assert_array_equal(agent.log_alpha.detach().numpy(), np.asarray(raw["agent"]["log_alpha"]))
    np.testing.assert_array_equal(agent.actor.fc_mean.weight.detach().numpy(),
                                  flatten_params(raw["agent"]["actor"])["fc_mean.weight"].T)
    for opt in (state.qf_opt, state.actor_opt, state.alpha_opt):
        assert all(float(st["step"]) == 1 for st in opt.state.values()) and opt.state
    mu = flatten_params(next(s for s in raw["qf_optimizer"] if isinstance(s, dict) and "mu" in s)["mu"])
    for path, p in agent.critics.named_parameters():
        np.testing.assert_array_equal(state.qf_opt.state[p]["exp_avg"].numpy(), mu[path])
