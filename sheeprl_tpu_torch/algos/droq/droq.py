"""DroQ, coupled (the port of sheeprl_tpu/algos/droq/droq.py): SAC at a high
update-to-data ratio with dropout and LayerNorm critics.

    python -m sheeprl_tpu_torch droq --env_id Pendulum-v1 [--device cpu]

The loop, its checkpoints (SAC's key contract), resume, `--eval_only` and
test episodes are SAC's (`algos/sac/sac.py:run`, with its optimizers,
policy step and `test`). The train step (`make_train_step`) takes
`gradient_steps` critic rounds, each a joint update of the ensemble and an
EMA of the targets, then one actor and temperature update on a fresh
batch against the mean of the critics.

Where the draws live: the generator on the run's device draws, in place
into the graph's own input tensor, the target's and the actor's sampling
noise and the uniforms of every dropout mask of a step (the target
critics' and the critics' `[G, layers, n, B, hidden]`, the actor update's
`[layers, n, B, hidden]`: about 42 MB a step at the defaults, G 20, B 256,
width 256, 2 critics), so no mask crosses from the host. The rest is
SAC's.

Not ported: SAC's list, and the reference's `--on_nonfinite`."""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ...utils.evaluation import parse_run_args
from ...utils.registry import register_algorithm
from ..sac.loss import critic_loss, entropy_loss, policy_loss
from ..sac.sac import DrawLayout, SACTrainState, _adam_step, run
from .agent import DROQAgent
from .args import DROQArgs

__all__ = ["build_agent", "droq_draws", "main", "make_train_step"]


def build_agent(args: DROQArgs, obs_dim: int, act_dim: int, low, high, generator: torch.Generator) -> DROQAgent:
    """The agent the config describes, on the CPU."""
    return DROQAgent(obs_dim, act_dim, dropout=args.dropout, num_critics=args.num_critics,
                     actor_hidden_size=args.actor_hidden_size, critic_hidden_size=args.critic_hidden_size,
                     action_low=low, action_high=high, alpha=args.alpha, tau=args.tau, precision=args.precision,
                     generator=generator)


def droq_draws(args: DROQArgs, act_dim: int, layers: int = 2) -> DrawLayout:
    """A DroQ train step's randomness: the normals of the target's next
    actions `[G, B, act]` and of the actor's sample `[B, act]`, then the
    dropout uniforms of the target critics and the critics in each round
    `[G, layers, n, B, hidden]` and of the critics in the actor's update
    `[layers, n, B, hidden]`."""
    G, B = args.gradient_steps, args.per_rank_batch_size
    masks = (layers, args.num_critics, B, args.critic_hidden_size)
    return DrawLayout({"target": (G, B, act_dim), "actor": (B, act_dim)},
                      {"target_masks": (G, *masks), "critic_masks": (G, *masks), "actor_masks": masks})


def make_train_step(args: DROQArgs, layout: DrawLayout) -> Callable:
    """The update of one env step (reference droq.py:66-150) ->
    `train_step(state, data, draws, actor_obs) -> losses [3]`: for each of
    the G batches of `data` (`[G, B, ...]`, SAC's keys), the TD target from
    the dropout-active target critics, one joint update of the critics and
    the EMA of the targets; then the actor's update on `actor_obs` (`[B,
    obs]`, a fresh batch) against the mean over the critics, the
    temperature detached, and the temperature's. -> the mean value loss
    over G, the policy and the temperature loss."""

    def train_step(state: SACTrainState, data: dict, draws: torch.Tensor, actor_obs: torch.Tensor) -> torch.Tensor:
        agent = state.agent
        d = layout.views(draws)
        critic_params, actor_params = list(agent.critics.parameters()), list(agent.actor.parameters())
        qf_losses = []
        for g in range(data["observations"].shape[0]):
            next_q = agent.get_next_target_q_values(data["next_observations"][g], data["rewards"][g],
                                                    data["dones"][g], args.gamma, d["target"][g],
                                                    list(d["target_masks"][g]))
            q = agent.critics(data["observations"][g], data["actions"][g], list(d["critic_masks"][g]))
            qf_l = critic_loss(q, next_q)
            _adam_step(state.qf_opt, critic_params, qf_l)
            agent.qfs_target_ema()
            qf_losses.append(qf_l.detach())
        actions, logprobs = agent.actor(actor_obs, d["actor"])
        mean_q = agent.critics(actor_obs, actions, list(d["actor_masks"])).mean(dim=-1, keepdim=True)
        actor_l = policy_loss(agent.alpha.detach(), logprobs, mean_q)
        _adam_step(state.actor_opt, actor_params, actor_l)
        alpha_l = entropy_loss(agent.log_alpha, logprobs, agent.target_entropy)
        _adam_step(state.alpha_opt, [agent.log_alpha], alpha_l)
        return torch.stack([torch.stack(qf_losses).mean(), actor_l.detach(), alpha_l.detach()])

    return train_step


def _actor_batch(args: DROQArgs, obs_dim: int, device) -> tuple[Callable, Callable]:
    """DroQ's fourth train-step input: a fresh batch's observations for the
    actor's update (reference droq.py:84)."""
    B = args.per_rank_batch_size
    return (lambda global_step, rb: rb.sample(B)["observations"]), (lambda: torch.zeros((B, obs_dim), device=device))


@register_algorithm()
def main(argv: Sequence[str] | None = None) -> None:
    run(parse_run_args(DROQArgs, argv), "droq", build_agent, make_train_step, droq_draws, _actor_batch)
