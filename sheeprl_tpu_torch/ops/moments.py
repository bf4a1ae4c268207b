"""Percentile-EMA return normalizer (the port of sheeprl_tpu/ops/moments.py,
DreamerV3's `Moments`). `torch.quantile` and `jnp.quantile` both default
to linear interpolation between the two nearest ranks."""

from __future__ import annotations

import torch

__all__ = ["Moments"]


class Moments:
    """EMA of the low/high return percentiles; `update` returns
    (offset, invscale) = (low, max(1/maximum, high - low)) for normalising
    lambda returns. The state is two f32 scalars, updated in place on the
    device, so a train step captured in a CUDA graph reads and writes the
    same two tensors at every replay. They live on `device`, or move once
    to the device of the first update; the percentile pair `q` is built
    with them, never inside an update (a host-to-device copy, which a
    capture refuses)."""

    def __init__(self, decay: float = 0.99, maximum: float = 1e8, percentile_low: float = 0.05,
                 percentile_high: float = 0.95, device=None):
        self.decay = decay
        self.maximum = maximum
        self.percentile_low = percentile_low
        self.percentile_high = percentile_high
        self._place(torch.device("cpu") if device is None else torch.device(device))

    def _place(self, device: torch.device) -> None:
        self.low = torch.zeros((), device=device)
        self.high = torch.zeros((), device=device)
        self.q = torch.tensor([self.percentile_low, self.percentile_high], device=device)

    def update(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        flat = x.detach().reshape(-1).float()
        if self.low.device != flat.device:  # once, before any capture
            low, high = self.low, self.high
            self._place(flat.device)
            self.low.copy_(low)
            self.high.copy_(high)
        q = torch.quantile(flat, self.q)
        self.low.copy_(self.decay * self.low + (1.0 - self.decay) * q[0])
        self.high.copy_(self.decay * self.high + (1.0 - self.decay) * q[1])
        invscale = torch.clamp(self.high - self.low, min=1.0 / self.maximum)
        return self.low, invscale

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The EMA state, as the reference's checkpoint holds it: `low`,
        `high` (the decay and percentiles come from the config)."""
        return {"low": self.low.detach().clone(), "high": self.high.detach().clone()}

    def load_state_dict(self, state: dict[str, torch.Tensor]) -> None:
        """Copy a saved state into the live tensors (their identity kept)."""
        self.low.copy_(torch.as_tensor(state["low"], dtype=torch.float32))
        self.high.copy_(torch.as_tensor(state["high"], dtype=torch.float32))
