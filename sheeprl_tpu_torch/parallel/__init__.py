"""Runtime helpers across devices (the port of sheeprl_tpu/parallel/): so far
`anakin.AnakinStats`, the Anakin collection gauges."""

from .anakin import AnakinStats

__all__ = ["AnakinStats"]
