"""GRU cell and sequence GRUs: the port of `sstts/model/rnn.py` (76-158).

Parameters keep the flax names and the fused r, z, n layout (wx (D, 3H),
wh (H, 3H), b (3H,)), so weight conversion is a table.  Whole sequences go
through `sstts_torch.ops.gru.gru_sequence`, which runs the CUDA kernel on
the card and its plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sstts_torch.ops.gru import gru_sequence, gru_step_math


class _GRUParams(nn.Module):
    def __init__(self, d_in: int, features: int):
        super().__init__()
        self.features = features
        self.wx = nn.Parameter(torch.empty(d_in, 3 * features))
        self.wh = nn.Parameter(torch.empty(features, 3 * features))
        self.b = nn.Parameter(torch.zeros(3 * features))


class GRUCell(_GRUParams):
    """Fused-gate GRU step: (x (B, D), h (B, H)) -> new h (B, H)."""

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return gru_step_math(x, h, self.wx, self.wh, self.b)


class UnidirectionalGRU(_GRUParams):
    """(B, T, D), optional (B, T) mask -> (B, T, H); `reverse` scans right to
    left with outputs in the original order; the carry freezes on padding."""

    def __init__(self, d_in: int, features: int, reverse: bool = False):
        super().__init__(d_in, features)
        self.reverse = reverse

    def forward(
        self, xs: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return gru_sequence(xs, self.wx, self.wh, self.b, mask, self.reverse)


class BiGRU(nn.Module):
    """Bidirectional GRU: concat(forward, backward) -> (B, T, 2H).  The input
    is masked before both directions."""

    def __init__(self, d_in: int, features: int):
        super().__init__()
        self.forward_gru = UnidirectionalGRU(d_in, features)
        self.backward_gru = UnidirectionalGRU(d_in, features, reverse=True)

    def forward(
        self, xs: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if mask is not None:
            xs = xs * mask[..., None].to(xs.dtype)
        fwd = self.forward_gru(xs, mask)
        bwd = self.backward_gru(xs, mask)
        return torch.cat([fwd, bwd], dim=-1)
