"""DreamerV3 helpers (the port of sheeprl_tpu/algos/dreamer_v3/utils.py's
`make_device_preprocess`)."""

from __future__ import annotations

import torch

__all__ = ["make_device_preprocess"]


def make_device_preprocess(cnn_keys):
    """Observation normalization on the device: the host ships RAW obs
    (uint8 pixels — 4x less transfer than pre-normalized f32) and images
    become float32 in [0, 1] where the step runs. Key-based,
    not dtype-based, like the reference."""
    cnn = frozenset(cnn_keys)

    def prep(o: dict) -> dict:
        return {
            k: v.to(torch.float32) / 255.0 if k in cnn else v.to(torch.float32)
            for k, v in o.items()
        }

    return prep
