"""Observation and action spaces without gymnasium: only what the port
reads of a space (`shape`, `dtype`, `n`, `nvec`, `spaces`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = ["Box", "Discrete", "MultiDiscrete", "Dict"]


@dataclass(frozen=True)
class Box:
    low: float
    high: float
    shape: tuple[int, ...]
    dtype: np.dtype = np.dtype(np.float32)

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))
        object.__setattr__(self, "dtype", np.dtype(self.dtype))


@dataclass(frozen=True)
class Discrete:
    n: int
    shape: tuple[int, ...] = ()
    dtype: np.dtype = np.dtype(np.int64)


class MultiDiscrete:
    def __init__(self, nvec: Sequence[int]):
        self.nvec = tuple(int(n) for n in nvec)
        self.dtype = np.dtype(np.int64)

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.nvec),)


@dataclass(frozen=True)
class Dict:
    spaces: dict = field(default_factory=dict)
