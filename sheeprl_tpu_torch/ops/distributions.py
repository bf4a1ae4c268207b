"""The distributions of sheeprl_tpu/ops/distributions.py that DreamerV3 and
PPO sample from and train with: the one-hot categorical of the stochastic
state and the actors, Normal (PPO's continuous actions), the truncated
normal and the tanh-squashed normal (DreamerV3's continuous actors),
Bernoulli (the continue head), the DreamerV3 trio Symlog / MSE /
TwoHotEncoding, and the categorical and Gaussian KLs.

Sampling takes either injected Gumbel noise (the parity tests feed the
reference's own draw) or an explicit `torch.Generator`: a one-hot sample is
`one_hot(argmax(logits + gumbel))`, the same Gumbel-max construction as
`jax.random.categorical`. A continuous sample takes its uniforms: floats
`u` in [0, 1), as `torch.rand` and `jax.random.uniform` give them, mapped
as JAX maps its own floats (`open_uniform`: `uniform(minval=eps,
maxval=1-eps)`, the truncated normal's draw; `standard_normal`:
`jax.random.normal`'s `sqrt(2) erfinv(u)`), so a parity test that feeds
the reference's floats gets the reference's draw.
`TwoHotEncodingDistribution.log_prob` goes through the two-hot kernel
(`ops/kernels/two_hot.py`) for every tensor."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .kernels.two_hot import two_hot_log_prob
from .math import symexp, symlog

__all__ = [
    "Bernoulli", "Independent", "MSEDistribution", "Normal", "OneHotCategorical", "SymlogDistribution",
    "TanhNormal", "TruncatedNormal", "TruncatedStandardNormal", "TwoHotEncodingDistribution", "gumbel_noise",
    "kl_categorical", "kl_normal", "open_uniform", "standard_normal", "unimix_logits",
]


_LOG_SQRT_2PI = 0.5 * math.log(2 * math.pi)
_LOG_SQRT_2PI_E = 0.5 * math.log(2 * math.pi * math.e)
_EPS32 = float(torch.finfo(torch.float32).eps)
# jax.random.normal's lower bound: the float32 after -1 towards 0
_NORMAL_LO = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))


def open_uniform(u: torch.Tensor) -> torch.Tensor:
    """Floats `u` in [0, 1) -> uniforms in [eps, 1 - eps), as
    `jax.random.uniform(minval=eps, maxval=1-eps)` maps its floats:
    `max(eps, u * (1 - 2 eps) + eps)` in f32 (eps of float32)."""
    return torch.clamp_min(u.float() * (1.0 - 2.0 * _EPS32) + _EPS32, _EPS32)


def standard_normal(u: torch.Tensor) -> torch.Tensor:
    """Floats `u` in [0, 1) -> standard normal draws, as `jax.random.normal`
    maps its floats: `sqrt(2) * erfinv(max(lo, u * 2 + lo))`, lo the float32
    after -1."""
    return math.sqrt(2.0) * torch.erfinv(torch.clamp_min(u.float() * 2.0 + _NORMAL_LO, _NORMAL_LO))


def _sum_last(x: torch.Tensor, ndims: int) -> torch.Tensor:
    return x if ndims == 0 else x.sum(dim=tuple(range(-ndims, 0)))


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
    def log_probs(self) -> torch.Tensor:
        return torch.log_softmax(self.logits, dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        idx = torch.argmax(self.logits, dim=-1)
        return F.one_hot(idx, self.logits.shape[-1]).to(self.logits.dtype)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return (self.log_probs * x).sum(dim=-1)

    def entropy(self) -> torch.Tensor:
        lp = self.log_probs
        return -(lp.exp() * lp).sum(dim=-1)

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


class Normal:
    """Gaussian with elementwise `loc` and `scale`; a sample draws from an
    explicit `torch.Generator` (the reference threads a JAX key)."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    def sample(self, generator: torch.Generator | None = None, sample_shape: tuple[int, ...] = ()) -> torch.Tensor:
        shape = tuple(sample_shape) + torch.broadcast_shapes(self.loc.shape, self.scale.shape)
        eps = torch.randn(shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)
        return self.loc + self.scale * eps

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        z = (x - self.loc) / self.scale
        return -0.5 * torch.square(z) - torch.log(self.scale) - _LOG_SQRT_2PI

    def entropy(self) -> torch.Tensor:
        return _LOG_SQRT_2PI_E + torch.log(self.scale) * torch.ones_like(self.loc)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    @property
    def stddev(self) -> torch.Tensor:
        return self.scale * torch.ones_like(self.loc)


class Independent:
    """Reinterpret the trailing `event_ndims` batch dims as event dims."""

    def __init__(self, base, event_ndims: int = 1):
        self.base = base
        self.event_ndims = event_ndims

    def sample(self, generator: torch.Generator | None = None, sample_shape: tuple[int, ...] = ()) -> torch.Tensor:
        return self.base.sample(generator, sample_shape)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return _sum_last(self.base.log_prob(x), self.event_ndims)

    def entropy(self) -> torch.Tensor:
        return _sum_last(self.base.entropy(), self.event_ndims)

    @property
    def mean(self) -> torch.Tensor:
        return self.base.mean

    @property
    def mode(self) -> torch.Tensor:
        return self.base.mode


class TanhNormal:
    """tanh(Normal(loc, scale)) with the analytic log-det-Jacobian
    correction; the event axis is the last (log_probs summed over it). No
    entropy, as in the reference (`ops/distributions.py:95-137`)."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor):
        self.loc = loc
        self.scale = scale

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """A reparameterized draw from the floats `u` (shaped like the sample)."""
        return torch.tanh(self.loc + self.scale * standard_normal(u))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        # f32 throughout: in bf16 the clip bound 1 - 1e-6 rounds to exactly
        # 1.0 and atanh(1.0) = inf would poison the loss
        value = value.float()
        eps = 1e-6
        x = torch.atanh(torch.clamp(value, -1.0 + eps, 1.0 - eps))
        base_lp = -0.5 * torch.square((x - self.loc) / self.scale) - torch.log(self.scale) - _LOG_SQRT_2PI
        # log(1 - tanh(x)^2) = 2 * (log 2 - x - softplus(-2x)), numerically stable
        correction = 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))
        return (base_lp - correction).sum(dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        return torch.tanh(self.loc)

    @property
    def mean(self) -> torch.Tensor:
        return torch.tanh(self.loc)


class TruncatedStandardNormal:
    """The standard normal truncated to [a, b] (the reference's
    `ops/distributions.py:139-191`): the normalizer Z is clamped at f32's
    eps and the cdf clipped to [0, 1], as there."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        self.a = a
        self.b = b

    @staticmethod
    def _little_phi(x: torch.Tensor) -> torch.Tensor:
        return torch.exp(-0.5 * torch.square(x)) / math.sqrt(2 * math.pi)

    @staticmethod
    def _big_phi(x: torch.Tensor) -> torch.Tensor:
        return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0)))

    @staticmethod
    def _inv_big_phi(x: torch.Tensor) -> torch.Tensor:
        # the one deviation from the reference: erfinv's argument is kept
        # inside (-1, 1). Where Phi(a) + p Z rounds to 1 in float32 (loc near
        # -1, a small scale, p near 1 - eps) erfinv(1) = inf; the reference's
        # compiled product-and-sum rounds once and stays finite there
        return math.sqrt(2.0) * torch.erfinv(torch.clamp(2.0 * x - 1.0, _NORMAL_LO, -_NORMAL_LO))

    def _z(self) -> torch.Tensor:
        return torch.clamp_min(self._big_phi(self.b) - self._big_phi(self.a), _EPS32)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return -_LOG_SQRT_2PI - torch.log(self._z()) - 0.5 * torch.square(x)

    def cdf(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp((self._big_phi(x) - self._big_phi(self.a)) / self._z(), 0.0, 1.0)

    def icdf(self, p: torch.Tensor) -> torch.Tensor:
        return self._inv_big_phi(self._big_phi(self.a) + p * self._z())

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """A reparameterized draw from the floats `u` in [0, 1) (shaped like
        the sample: leading sample axes, then the batch): the icdf of
        `open_uniform(u)`, the reference's draw of its floats."""
        return self.icdf(open_uniform(u))

    def entropy(self) -> torch.Tensor:
        z = self._z()
        phi_a, phi_b = self._little_phi(self.a), self._little_phi(self.b)
        lpbb = (phi_b * self.b - phi_a * self.a) / z
        return _LOG_SQRT_2PI_E + torch.log(z) - 0.5 * lpbb

    @property
    def mean(self) -> torch.Tensor:
        return -(self._little_phi(self.b) - self._little_phi(self.a)) / self._z()


class TruncatedNormal:
    """Normal(loc, scale) truncated to [low, high] (the reference's
    `ops/distributions.py:194-222`), over `TruncatedStandardNormal`."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor, low: torch.Tensor, high: torch.Tensor):
        self.loc, self.scale, self.low, self.high = loc, scale, low, high

    def _std(self) -> TruncatedStandardNormal:
        return TruncatedStandardNormal((self.low - self.loc) / self.scale, (self.high - self.loc) / self.scale)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self._std().log_prob((x - self.loc) / self.scale) - torch.log(self.scale)

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        return self._std().sample(u) * self.scale + self.loc

    def entropy(self) -> torch.Tensor:
        return self._std().entropy() + torch.log(self.scale)

    @property
    def mean(self) -> torch.Tensor:
        return self._std().mean * self.scale + self.loc

    @property
    def mode(self) -> torch.Tensor:
        return torch.minimum(torch.maximum(self.loc, self.low), self.high)


class Bernoulli:
    """Bernoulli from logits; `mode` is the safe > 0.5 threshold (the
    continue head's BernoulliSafeMode in the reference)."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    @property
    def probs(self) -> torch.Tensor:
        return torch.sigmoid(self.logits)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        # -BCE-with-logits, numerically stable
        return -(F.softplus(-self.logits) * x + F.softplus(self.logits) * (1.0 - x))

    def entropy(self) -> torch.Tensor:
        return F.softplus(self.logits) - self.logits * self.probs

    @property
    def mode(self) -> torch.Tensor:
        return (self.probs > 0.5).to(torch.float32)

    @property
    def mean(self) -> torch.Tensor:
        return self.probs


class SymlogDistribution:
    """MSE (or L1) in symlog space."""

    def __init__(self, mode: torch.Tensor, dims: int = 1, dist: str = "mse", agg: str = "sum",
                 tol: float = 1e-8):
        if dist not in ("mse", "abs"):
            raise NotImplementedError(dist)
        self._mode, self.dims, self.dist, self.agg, self.tol = mode, dims, dist, agg, tol

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        diff = self._mode - symlog(value)
        distance = diff * diff if self.dist == "mse" else diff.abs()
        distance = torch.where(distance < self.tol, torch.zeros_like(distance), distance)
        if self.agg == "mean":
            return -distance.mean(dim=tuple(range(-self.dims, 0)))
        return -_sum_last(distance, self.dims)

    @property
    def mode(self) -> torch.Tensor:
        return symexp(self._mode)

    mean = mode


class MSEDistribution:
    """Plain MSE pseudo-likelihood."""

    def __init__(self, mode: torch.Tensor, dims: int = 1, agg: str = "sum"):
        self._mode, self.dims, self.agg = mode, dims, agg

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        diff = self._mode - value
        distance = diff * diff
        if self.agg == "mean":
            return -distance.mean(dim=tuple(range(-self.dims, 0)))
        return -_sum_last(distance, self.dims)

    @property
    def mode(self) -> torch.Tensor:
        return self._mode

    mean = mode


class TwoHotEncodingDistribution:
    """255-bin two-hot over symlog values — DreamerV3's reward/critic heads.
    `log_prob(x)` cross-entropies a two-hot target against the logits
    through the two-hot kernel; mean/mode decode via symexp(probs . bins)."""

    def __init__(self, logits: torch.Tensor, dims: int = 1, low: float = -20.0, high: float = 20.0):
        self.logits, self.dims, self.low, self.high = logits, dims, low, high

    @property
    def bins(self) -> torch.Tensor:
        return torch.linspace(self.low, self.high, self.logits.shape[-1], device=self.logits.device)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    @property
    def mean(self) -> torch.Tensor:
        # keepdim so the event shape stays (..., 1) like the reference
        val = (self.probs * self.bins).sum(dim=-1, keepdim=True)
        if self.dims > 1:
            val = _sum_last(val[..., 0], self.dims - 1)[..., None]
        return symexp(val)

    @property
    def mode(self) -> torch.Tensor:
        return self.mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x [..., 1] raw-scale targets."""
        k = self.logits.shape[-1]
        lp = two_hot_log_prob(
            symlog(x).reshape(-1, 1).float().contiguous(),
            self.logits.reshape(-1, k).contiguous(),
            self.bins[None].contiguous(),
        ).reshape(*x.shape[:-1], 1)
        return _sum_last(lp, self.dims)


def kl_categorical(p_logits: torch.Tensor, q_logits: torch.Tensor, event_ndims: int = 1) -> torch.Tensor:
    """KL(p || q) between categoricals over the trailing axis, summed over
    `event_ndims` trailing batch dims (the 32x32 discrete latent)."""
    p_log = torch.log_softmax(p_logits, dim=-1)
    q_log = torch.log_softmax(q_logits, dim=-1)
    return _sum_last((p_log.exp() * (p_log - q_log)).sum(dim=-1), event_ndims)


def kl_normal(p: Normal, q: Normal, event_ndims: int = 1) -> torch.Tensor:
    """KL(p || q) between diagonal Gaussians, summed over `event_ndims`
    trailing dims (DreamerV1's state KL): 0.5 (r + ((mu_p - mu_q) /
    sigma_q)^2 - 1 - log r), r = (sigma_p / sigma_q)^2."""
    var_ratio = torch.square(p.scale / q.scale)
    t1 = torch.square((p.loc - q.loc) / q.scale)
    return _sum_last(0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio)), event_ndims)
