"""Compilation for the port (the counterpart of sheeprl_tpu/compile/): the
plan of whole-step CUDA graphs (`plan.py`) and measured decisions (the part
of `decisions.py` the int8 serving ladder needs)."""

from .plan import CompilePlan, WarmJit, graphed

__all__ = ["CompilePlan", "WarmJit", "graphed"]
