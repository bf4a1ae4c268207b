"""SAC, coupled (the port of sheeprl_tpu/algos/sac/sac.py), over the port's
host envs:

    python -m sheeprl_tpu_torch sac --env_id Pendulum-v1 [--device cpu]

Before `learning_starts` the envs take uniform random actions, then the
policy's sampled ones. Each env step adds one row an env to a
`ReplayBuffer` on the device; from `learning_starts - 1` on, each step
takes one train step (`make_train_step`): `gradient_steps` batches of
`per_rank_batch_size` rows, gathered at once, each running critic -> target
EMA (every `target_network_frequency` steps) -> actor -> temperature. At
`learning_starts - 1` a catch-up burst takes `learning_starts` train steps.

Where the draws live: one generator on the run's device, seeded by
`--seed`, draws the policy's sampling noise and each train step's noise
(the target's next actions and the actor's, `[2, G, B, act]`, DroQ's
dropout draws too), filled in place into the graph's own input tensor; the
buffer's CPU generator draws the sampled rows; a numpy generator seeded
`(seed, first step)` the random actions. A checkpoint keeps the device
generator's state (`generator`), so a resume on the same kind of device
continues its stream; on the other kind it is reseeded
`seed + global_step`.

Checkpoints (`ckpt_<step>`, the reference's keys `agent`, `qf_optimizer`,
`actor_optimizer`, `alpha_optimizer`, `global_step`, plus `generator`) are
written at `--checkpoint_every` steps, at `--dry_run` and at the last step,
with `--checkpoint_buffer` also the buffer (`ckpt_<step>.buffer.npz`).
`--checkpoint_path` resumes at `global_step + 1` (explicit flags override
the checkpoint's config); without the buffer the run re-collects
`learning_starts` steps first. `--eval_only` takes no step. Every run ends
with `--test_episodes` greedy episodes, each in a fresh env.

On the card the train step and the policy step are CUDA graphs
(`compile/plan.py`): the schedule (the EMA gate) is a device bool, the
temperature never leaves the device, and the Adams, the critics and their
targets are updated in place.

Not ported: `--on_nonfinite` (the non-finite guard), the sanitizer,
telemetry spans, the profiler, `Pipeline`, a mesh of more than one
device, `--memmap_buffer`, and `sac_decoupled`."""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ...compile.plan import CompilePlan
from ...data.buffers import ReplayBuffer
from ...ops.optim import Adam, adam, load_optimizer_state
from ...utils.checkpoint import load_checkpoint, save_checkpoint
from ...utils.device import resolve_device
from ...utils.env import make_env
from ...utils.evaluation import parse_run_args, run_test_episodes
from ...utils.logger import create_logger
from ...utils.registry import register_algorithm
from .agent import SACActor, SACAgent
from .args import SACArgs
from .loss import critic_loss, entropy_loss, policy_loss
from .utils import test

__all__ = [
    "DrawLayout", "SACTrainState", "agent_state", "build_agent", "checkpoint_state", "main", "make_optimizers", "make_train_step",
    "policy_step", "restore_state", "run",
]

LOSSES = ("Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss")


@dataclasses.dataclass(eq=False)
class SACTrainState:
    """The agent and its three Adams; a train step updates them in place."""

    agent: SACAgent
    qf_opt: Adam
    actor_opt: Adam
    alpha_opt: Adam


def make_optimizers(args: SACArgs, agent: SACAgent) -> tuple[Adam, Adam, Adam]:
    """The critics', the actor's and the temperature's Adams, eps 1e-4
    (the reference's `optax.adam` settings, sac.py:72)."""
    return (adam(agent.critics.parameters(), args.q_lr, 1e-4), adam(agent.actor.parameters(), args.policy_lr, 1e-4),
            adam([agent.log_alpha], args.alpha_lr, 1e-4))


def build_agent(args: SACArgs, obs_dim: int, act_dim: int, low, high, generator: torch.Generator) -> SACAgent:
    """The agent the config describes, on the CPU."""
    return SACAgent(obs_dim, act_dim, num_critics=args.num_critics, actor_hidden_size=args.actor_hidden_size,
                    critic_hidden_size=args.critic_hidden_size, action_low=low, action_high=high, alpha=args.alpha,
                    tau=args.tau, precision=args.precision, generator=generator)


class DrawLayout:
    """A train step's randomness as one flat f32 tensor: named sections of
    standard normals first, then of uniforms in [0, 1). `fill` draws them
    in place (two launches), `views` cuts the sections out, `pack` builds
    the tensor from given arrays (a test's, rebuilt from the reference's
    keys)."""

    def __init__(self, normal: dict[str, tuple[int, ...]], uniform: dict[str, tuple[int, ...]] | None = None):
        self.shapes = {**normal, **(uniform or {})}
        self.n_normal = sum(math.prod(s) for s in normal.values())
        self.size = sum(math.prod(s) for s in self.shapes.values())

    def new(self, device) -> torch.Tensor:
        return torch.zeros(self.size, device=device)

    def fill(self, draws: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        draws[: self.n_normal].normal_(generator=generator)
        draws[self.n_normal:].uniform_(generator=generator)
        return draws

    def views(self, draws: torch.Tensor) -> dict[str, torch.Tensor]:
        out, at = {}, 0
        for name, shape in self.shapes.items():
            n = math.prod(shape)
            out[name] = draws[at:at + n].view(shape)
            at += n
        return out

    def pack(self, arrays: dict, device="cpu") -> torch.Tensor:
        return torch.cat([torch.from_numpy(np.array(arrays[k], np.float32)).reshape(-1)
                          for k in self.shapes]).to(device)


def sac_draws(args: SACArgs, act_dim: int) -> DrawLayout:
    """A SAC train step's noise: the target's next actions and the actor's
    sample, `[gradient_steps, batch, act]` each."""
    shape = (args.gradient_steps, args.per_rank_batch_size, act_dim)
    return DrawLayout({"target": shape, "actor": shape})


def _adam_step(optimizer: Adam, params: list[torch.Tensor], loss: torch.Tensor) -> None:
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def make_train_step(args: SACArgs, layout: DrawLayout) -> Callable:
    """The update of one env step (reference sac.py:80-160) ->
    `train_step(state, data, draws, do_ema) -> losses [3]`. `data` holds
    `[gradient_steps, batch, ...]` tensors (`observations`,
    `next_observations`, `actions`, `rewards`, `dones`), `draws` the
    `layout`'s flat tensor, `do_ema` a device bool. Each of the G batches
    runs the critics' update, the gated target EMA, the actor's update
    (against the updated critics, the temperature detached) and the
    temperature's (from the actor's pre-update log-probs). -> the mean over
    G of the value, policy and temperature losses."""

    def train_step(state: SACTrainState, data: dict, draws: torch.Tensor, do_ema: torch.Tensor) -> torch.Tensor:
        agent = state.agent
        noise = layout.views(draws)
        critic_params, actor_params = list(agent.critics.parameters()), list(agent.actor.parameters())
        losses = []
        for g in range(data["observations"].shape[0]):
            obs, actions = data["observations"][g], data["actions"][g]
            next_q = agent.get_next_target_q_values(data["next_observations"][g], data["rewards"][g],
                                                    data["dones"][g], args.gamma, noise["target"][g])
            qf_l = critic_loss(agent.critics(obs, actions), next_q)
            _adam_step(state.qf_opt, critic_params, qf_l)
            agent.qfs_target_ema(do_ema)
            new_actions, logprobs = agent.actor(obs, noise["actor"][g])
            min_q = agent.critics(obs, new_actions).min(dim=-1, keepdim=True).values
            actor_l = policy_loss(agent.alpha.detach(), logprobs, min_q)
            _adam_step(state.actor_opt, actor_params, actor_l)
            alpha_l = entropy_loss(agent.log_alpha, logprobs, agent.target_entropy)
            _adam_step(state.alpha_opt, [agent.log_alpha], alpha_l)
            losses.append(torch.stack([qf_l, actor_l, alpha_l]).detach())
        return torch.stack(losses).mean(0)

    return train_step


@torch.no_grad()
def policy_step(actor: SACActor, obs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The rollout's actions, sampled with the standard-normal `noise`
    (reference sac.py:163)."""
    return actor(obs, noise)[0]


def agent_state(agent: SACAgent) -> dict:
    """The checkpoint's `agent`: the reference's agent tree, one state_dict
    a field (`actor`, `critics`, `target_critics`) and `log_alpha`."""
    return {"actor": agent.actor.state_dict(), "critics": agent.critics.state_dict(),
            "target_critics": agent.target_critics.state_dict(), "log_alpha": agent.log_alpha.detach()}


def checkpoint_state(state: SACTrainState, global_step: int, generator: torch.Generator) -> dict:
    """The checkpoint's dict: the reference's key contract (sac.py:452-458)
    plus the draws' generator state."""
    return {"agent": agent_state(state.agent), "qf_optimizer": state.qf_opt.state_dict(),
            "actor_optimizer": state.actor_opt.state_dict(), "alpha_optimizer": state.alpha_opt.state_dict(),
            "global_step": global_step, "generator": generator.get_state()}


def restore_state(state: SACTrainState, ckpt: dict) -> None:
    """Load a checkpoint's agent and Adams into `state`."""
    agent, saved = state.agent, ckpt["agent"]
    for key in ("actor", "critics", "target_critics"):
        getattr(agent, key).load_state_dict(saved[key])
    with torch.no_grad():
        agent.log_alpha.copy_(saved["log_alpha"])
    for key, opt in (("qf_optimizer", state.qf_opt), ("actor_optimizer", state.actor_opt),
                     ("alpha_optimizer", state.alpha_opt)):
        load_optimizer_state(opt, ckpt[key])


def _static_draws(step, own: torch.Tensor) -> torch.Tensor:
    """The tensor to fill with a train step's draws: the captured step's
    own input (a replay then copies nothing), else `own`."""
    static = step.static_args()
    return own if static is None else static[2]


def run(args: SACArgs, algo: str, make_agent: Callable, make_step: Callable, make_layout: Callable,
        make_extra: Callable) -> None:
    """The off-policy loop SAC and DroQ share. `make_agent(args, obs_dim,
    act_dim, low, high, generator)` builds the agent on the CPU,
    `make_layout(args, act_dim)` the train step's `DrawLayout`,
    `make_step(args, layout)` the train step `(state, data, draws, extra)`;
    `make_extra(args, obs_dim, device)` -> (`extra(global_step, rb)`, the
    fourth argument at a step: SAC's EMA gate, DroQ's fresh observations
    for the actor; an example of it)."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        # the reference's float32 products are true float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    logger, run_dir = create_logger(args, algo)
    envs = [make_env(args.env_id, args.seed + i)() for i in range(args.num_envs)]
    obs_space, act_space = envs[0].observation_space, envs[0].action_space
    if len(obs_space.shape) != 1 or len(act_space.shape) != 1:
        raise ValueError(f"{algo} takes vector observations and continuous actions")
    obs_dim, act_dim = obs_space.shape[0], act_space.shape[0]
    low = np.broadcast_to(np.asarray(act_space.low, np.float32), (act_dim,))
    high = np.broadcast_to(np.asarray(act_space.high, np.float32), (act_dim,))

    agent = make_agent(args, obs_dim, act_dim, low, high, torch.Generator().manual_seed(args.seed)).to(device)
    state = SACTrainState(agent, *make_optimizers(args, agent))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    min_size = 2 if args.sample_next_obs else 1
    buffer_size = max(args.buffer_size // args.num_envs, min_size) if not args.dry_run else min_size
    rb = ReplayBuffer(buffer_size, args.num_envs, storage="device", device=device, obs_keys=("observations",),
                      seed=args.seed)
    start_step, restored_buffer, resumed = 1, False, None
    if args.checkpoint_path:
        ckpt = load_checkpoint(args.checkpoint_path, device)
        restore_state(state, ckpt)
        start_step = int(ckpt["global_step"]) + 1
        saved_gen = ckpt["generator"].cpu()
        if saved_gen.numel() == gen.get_state().numel():
            gen.set_state(saved_gen)
        else:  # written on the other kind of device
            gen.manual_seed(args.seed + start_step - 1)
        rb_path = args.checkpoint_path + ".buffer.npz"
        if args.checkpoint_buffer and os.path.exists(rb_path) and not args.eval_only:
            rb.load(rb_path)
            restored_buffer = True
        resumed = {"checkpoint": os.path.abspath(args.checkpoint_path), "start_step": start_step,
                   "buffer": restored_buffer}
        del ckpt
    action_rng = np.random.default_rng([args.seed, start_step])

    G, B = args.gradient_steps, args.per_rank_batch_size
    layout = make_layout(args, act_dim)
    extra_input, extra_example = make_extra(args, obs_dim, device)
    plan = CompilePlan.from_args(args)

    def _data_example() -> dict:
        shapes = {"observations": obs_dim, "next_observations": obs_dim, "actions": act_dim, "rewards": 1,
                  "dones": 1}
        return {k: torch.zeros((G, B, n), device=device) for k, n in shapes.items()}

    draws = layout.new(device)
    train_step = plan.register("train_step", make_step(args, layout), role="update", example=lambda: (
        state, _data_example(), layout.new(device), extra_example()))
    graphed_policy = plan.register("policy_step", policy_step, example=lambda: (
        agent.actor, torch.zeros((args.num_envs, obs_dim), device=device),
        torch.zeros((args.num_envs, act_dim), device=device)))

    num_steps = args.total_steps // args.num_envs if not args.dry_run else start_step
    learning_starts = args.learning_starts // args.num_envs if not args.dry_run else 0
    # the catch-up burst keeps the configured warm-up; a bufferless resume
    # re-collects before it updates
    base_learning_starts = learning_starts
    if args.checkpoint_path and not restored_buffer and not args.dry_run:
        learning_starts += start_step
    if args.eval_only:
        num_steps = start_step - 1  # no step: straight to the test episodes

    obs = np.stack([env.reset(seed=args.seed + i)[0] for i, env in enumerate(envs)]).astype(np.float32)
    ep_return, ep_len = np.zeros(args.num_envs), np.zeros(args.num_envs, np.int64)
    ended: list[tuple[float, int]] = []
    loss_sum, loss_n = torch.zeros(3, device=device), 0
    random_s = learn_s = burst_s = 0.0
    random_steps = learn_steps = train_calls = policy_calls = 0
    checkpoints: list[dict] = []
    plan.start()
    t_start = time.perf_counter()
    for global_step in range(start_step, num_steps + 1):
        t0 = time.perf_counter()
        if global_step < learning_starts:
            actions = action_rng.uniform(low, high, (args.num_envs, act_dim)).astype(np.float32)
        else:
            noise = torch.randn((args.num_envs, act_dim), generator=gen, device=device)
            actions = graphed_policy(agent.actor, torch.from_numpy(obs).to(device), noise).cpu().numpy()
            policy_calls += 1
        next_obs, real_next_obs = obs.copy(), obs.copy()
        rewards, dones = np.zeros(args.num_envs, np.float32), np.zeros(args.num_envs, np.float32)
        for i, env in enumerate(envs):
            o, r, term, trunc, _ = env.step(actions[i])
            rewards[i], dones[i] = r, float(term or trunc)
            real_next_obs[i] = o
            ep_return[i] += r
            ep_len[i] += 1
            if dones[i]:
                o, _ = env.reset()
                ended.append((float(ep_return[i]), int(ep_len[i])))
                ep_return[i], ep_len[i] = 0.0, 0
            next_obs[i] = o
        row = {"observations": obs[None], "actions": actions[None], "rewards": rewards[None, :, None],
               "dones": dones[None, :, None]}
        if not args.sample_next_obs:
            row["next_observations"] = real_next_obs[None]
        rb.add(row)
        obs = next_obs

        burst = False
        if global_step >= learning_starts - 1 and rb.can_sample(args.sample_next_obs):
            burst = global_step == learning_starts - 1 and base_learning_starts > 1
            for _ in range(base_learning_starts if burst else 1):
                sample = rb.sample(G * B, sample_next_obs=args.sample_next_obs)
                data = {k: v.reshape((G, B) + v.shape[1:]) for k, v in sample.items()}
                target = _static_draws(train_step, draws)
                layout.fill(target, gen)
                loss_sum += train_step(state, data, target, extra_input(global_step, rb))
                loss_n += 1
                train_calls += 1
        dt = time.perf_counter() - t0
        if burst:
            burst_s += dt
        elif global_step < learning_starts:
            random_s, random_steps = random_s + dt, random_steps + 1
        else:
            learn_s, learn_steps = learn_s + dt, learn_steps + 1

        if ended or (global_step == num_steps and loss_n):  # at episode ends, and the run's last losses
            rec = {"step": global_step,
                   "Time/step_per_second": (global_step - start_step + 1) / (time.perf_counter() - t_start)}
            if ended:
                rec["Rewards/rew_avg"] = float(np.mean([e[0] for e in ended]))
                rec["Game/ep_len_avg"] = float(np.mean([e[1] for e in ended]))
            if loss_n:
                rec.update(zip(LOSSES, (loss_sum / loss_n).tolist()))
                loss_sum.zero_()
                loss_n = 0
            logger.record(rec)
            ended.clear()
            if global_step % (10 * 200 * args.num_envs) < args.num_envs or global_step == num_steps:
                print(f"[{algo}] step {global_step}/{num_steps} " + " ".join(
                    f"{k.split('/')[1]} {rec[k]:.4g}" for k in ("Rewards/rew_avg", *LOSSES) if k in rec), flush=True)

        if (args.checkpoint_every > 0 and global_step % args.checkpoint_every == 0) or args.dry_run \
                or global_step == num_steps:
            ckpt_path = os.path.join(run_dir, "checkpoints", f"ckpt_{global_step}")
            t_save = time.perf_counter()
            nbytes = save_checkpoint(ckpt_path, checkpoint_state(state, global_step, gen), args)
            if args.checkpoint_buffer:
                rb.save(ckpt_path + ".buffer.npz")
            checkpoints.append({"path": ckpt_path, "step": global_step, "bytes": nbytes,
                                "save_ms": (time.perf_counter() - t_save) * 1e3})
    wall_s = time.perf_counter() - t_start
    for env in envs:
        env.close()
    plan.close()

    t_test = time.perf_counter()
    test_returns = run_test_episodes(
        lambda: test(agent.actor, make_env(args.env_id, args.seed)(), logger, args), args, logger)
    env_steps = max(num_steps - start_step + 1, 0) * args.num_envs
    logger.record({
        "event": "done", "algo": algo, "env_steps": env_steps, "train_calls": train_calls,
        "gradient_steps": train_calls * G, "policy_steps": policy_calls, "device": str(device), "wall_s": wall_s,
        "env_steps_per_s": env_steps / max(wall_s, 1e-9),
        "random_ms_per_step": random_s / max(random_steps, 1) * 1e3,
        "learn_ms_per_step": learn_s / max(learn_steps, 1) * 1e3, "burst_s": burst_s,
        "checkpoints": checkpoints, "resumed": resumed, "test_returns": test_returns,
        "test_ms": (time.perf_counter() - t_test) * 1e3, "compile": plan.gauges(), "compile_stats": plan.stats(),
    })
    print(f"[{algo}] done: {env_steps} env steps, {train_calls} train steps in {wall_s:.1f} s, test returns "
          f"{test_returns}, run dir {run_dir}", flush=True)


def _ema_gate(args: SACArgs, obs_dim: int, device) -> tuple[Callable, Callable]:
    """SAC's fourth train-step input: the EMA gate of a step, one of two
    device bools made once."""
    del obs_dim
    gates = (torch.tensor(False, device=device), torch.tensor(True, device=device))
    return (lambda global_step, rb: gates[global_step % args.target_network_frequency == 0]), gates[1].clone


@register_algorithm()
def main(argv: Sequence[str] | None = None) -> None:
    run(parse_run_args(SACArgs, argv), "sac", build_agent, make_train_step, sac_draws, _ema_gate)
