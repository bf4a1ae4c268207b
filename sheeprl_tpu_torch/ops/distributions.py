"""The categorical pieces of sheeprl_tpu/ops/distributions.py that the
DreamerV3 player samples from.

Sampling takes either injected Gumbel noise (the parity tests feed the
reference's own draw) or an explicit `torch.Generator`: a one-hot sample is
`one_hot(argmax(logits + gumbel))`, the same Gumbel-max construction as
`jax.random.categorical`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["OneHotCategorical", "gumbel_noise", "unimix_logits"]


def gumbel_noise(
    shape, generator: torch.Generator | None = None, device=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U)), U uniform in [tiny, 1): the
    formula of `jax.random.gumbel` (the generator's bits differ from
    JAX's)."""
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


class OneHotCategorical:
    """One-hot categorical over the trailing axis, from unnormalized logits."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        idx = torch.argmax(self.logits, dim=-1)
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)

    def sample(
        self, gumbel: torch.Tensor | None = None, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """One-hot draw by Gumbel-max: `gumbel` (shaped like the logits) when
        given, else fresh noise from `generator`."""
        if gumbel is None:
            gumbel = gumbel_noise(
                self.logits.shape, generator, self.logits.device, self.logits.dtype
            )
        idx = torch.argmax(gumbel + self.logits, dim=-1)
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)

    def rsample(
        self, gumbel: torch.Tensor | None = None, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """Straight-through sample: forward = one-hot draw, backward =
        d/d(probs)."""
        probs = self.probs
        return self.sample(gumbel, generator) + probs - probs.detach()


def unimix_logits(logits: torch.Tensor, unimix: float = 0.01) -> torch.Tensor:
    """Mix categorical probs with `unimix` uniform mass and return new logits
    (DreamerV3's 1% unimix)."""
    if unimix <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    uniform = torch.ones_like(probs) / probs.shape[-1]
    probs = (1.0 - unimix) * probs + unimix * uniform
    return torch.log(probs)
