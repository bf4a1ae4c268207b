"""Batched policy-inference serving tier (the port of sheeprl_tpu/serve):
micro-batched fixed-rung dispatch, hot-reloadable params, deadline shedding,
FLK1 socket transport."""
