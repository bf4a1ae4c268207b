"""LayerNorm-GRU cell (the port of sheeprl_tpu/nn/recurrent.py's
LayerNormGRUCell), the DreamerV2/V3 recurrence with the `sigmoid(u - 1)`
update-gate bias."""

from __future__ import annotations

import torch
import torch.nn as tnn

from ..ops.kernels.gru import layernorm_gru_cell
from .layers import LayerNorm, Linear

__all__ = ["LayerNormGRUCell"]


class LayerNormGRUCell(tnn.Module):
    def __init__(self, input_size: int, hidden_size: int, *, layer_norm: bool = True,
                 use_bias: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.proj = Linear(input_size + hidden_size, 3 * hidden_size, use_bias=use_bias,
                           generator=generator)
        self.norm = LayerNorm(3 * hidden_size) if layer_norm else None

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        # the reference's structural guard (sheeprl_tpu/nn/recurrent.py:75-81)
        if (
            self.norm is not None
            and self.norm.scale is not None
            and self.proj.bias is None
            and x.dim() == 2
        ):
            # weights follow the input dtype; the LN affine stays f32
            return layernorm_gru_cell(
                x, h, self.proj.weight.to(x.dtype), self.norm.scale, self.norm.offset,
                self.norm.eps,
            )
        parts = self.proj(torch.cat([x, h], dim=-1))
        if self.norm is not None:
            parts = self.norm(parts)
        r, c, u = parts.chunk(3, dim=-1)
        reset = torch.sigmoid(r)
        cand = torch.tanh(reset * c)
        update = torch.sigmoid(u - 1.0)
        return update * cand + (1.0 - update) * h
