"""Percentile-EMA return normalizer (the port of sheeprl_tpu/ops/moments.py,
DreamerV3's `Moments`). `torch.quantile` and `jnp.quantile` both default
to linear interpolation between the two nearest ranks."""

from __future__ import annotations

import torch

__all__ = ["Moments"]


class Moments:
    """EMA of the low/high return percentiles; `update` returns
    (offset, invscale) = (low, max(1/maximum, high - low)) for normalising
    lambda returns. The state is two f32 scalars on the device of the first
    update."""

    def __init__(self, decay: float = 0.99, maximum: float = 1e8, percentile_low: float = 0.05,
                 percentile_high: float = 0.95):
        self.decay = decay
        self.maximum = maximum
        self.percentile_low = percentile_low
        self.percentile_high = percentile_high
        self.low = torch.zeros(())
        self.high = torch.zeros(())

    def update(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        flat = x.detach().reshape(-1).float()
        q = torch.quantile(flat, torch.tensor([self.percentile_low, self.percentile_high], device=flat.device))
        low, high = self.low.to(flat.device), self.high.to(flat.device)
        self.low = self.decay * low + (1.0 - self.decay) * q[0]
        self.high = self.decay * high + (1.0 - self.decay) * q[1]
        invscale = torch.clamp(self.high - self.low, min=1.0 / self.maximum)
        return self.low, invscale

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The EMA state, as the reference's checkpoint holds it: `low`,
        `high` (the decay and percentiles come from the config)."""
        return {"low": self.low, "high": self.high}

    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        self.low = torch.as_tensor(state["low"], dtype=torch.float32).clone()
        self.high = torch.as_tensor(state["high"], dtype=torch.float32).clone()
