"""Measured decisions (the port of sheeprl_tpu/compile/decisions.py, the
part the int8 serving ladder needs)."""
