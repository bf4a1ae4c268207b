"""The DroQ agent (the port of sheeprl_tpu/algos/droq/agent.py,
https://arxiv.org/abs/2110.02034): SAC with critics of dropout and
LayerNorm (eps 1e-5) on every hidden layer, Linear -> dropout -> LayerNorm
-> ReLU. Dropout is active in every critic forward of a train step, the
target critics' too (the reference's torch modules stay in train mode);
each member takes its own draws, passed in as uniforms (`[n, B, hidden]` a
hidden layer). The target EMA is not gated. The paths are the
reference's, the members stacked as SAC's (`algos/sac/agent.py`)."""

from __future__ import annotations

import torch
import torch.nn as tnn

from ..sac.agent import CriticEnsemble, SACAgent, SACCritic

__all__ = ["DROQAgent", "DROQCritic", "DROQCriticEnsemble"]


class DROQCritic(SACCritic):
    """`n` dropout critics at once (the reference's `DROQCritic`,
    agent.py:21)."""

    def __init__(self, n: int, input_dim: int, *, hidden_size: int = 256, num_outputs: int = 1,
                 dropout: float = 0.0, precision: str = "float32", generator: torch.Generator | None = None):
        super().__init__(n, input_dim, hidden_size=hidden_size, num_outputs=num_outputs, layer_norm=True,
                         dropout=dropout, precision=precision, generator=generator)


class DROQCriticEnsemble(CriticEnsemble):
    """`n` dropout critics as one module with stacked parameters -> `[B, n]`
    (the reference's `DROQCriticEnsemble`, agent.py:49)."""

    def __init__(self, n: int, input_dim: int, *, hidden_size: int = 256, dropout: float = 0.0,
                 precision: str = "float32", generator: torch.Generator | None = None):
        tnn.Module.__init__(self)
        self.n = n
        self.members = DROQCritic(n, input_dim, hidden_size=hidden_size, dropout=dropout, precision=precision,
                                  generator=generator)


class DROQAgent(SACAgent):
    """Actor, dropout-critic ensemble, target critics and temperature (the
    reference's `DROQAgent`, agent.py:82); `get_next_target_q_values`
    takes the target critics' draws, `qfs_target_ema()` always updates."""

    def __init__(self, observation_dim: int, action_dim: int, *, dropout: float = 0.01, **kwargs):
        self.dropout = dropout
        super().__init__(observation_dim, action_dim, **kwargs)

    def critic_ensemble(self, n: int, input_dim: int, hidden_size: int, precision: str,
                        generator: torch.Generator | None) -> DROQCriticEnsemble:
        return DROQCriticEnsemble(n, input_dim, hidden_size=hidden_size, dropout=self.dropout, precision=precision,
                                  generator=generator)
