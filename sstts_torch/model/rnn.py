"""GRU cell and sequence GRUs: the port of `sstts/model/rnn.py` (49-158).

Parameters keep the flax names and the fused r, z, n layout (wx (D, 3H),
wh (H, 3H), b (3H,)), so weight conversion is a table.  Whole sequences go
through `sstts_torch.ops.gru.gru_sequence`, which runs the CUDA kernel on
the card and its plain version on the CPU.

The GRUs compute in f32 under a bf16 compute dtype, as the reference's do:
the cell upcasts its inputs and rounds its new state to its `dtype` (the
decoder's carry), and the sequence GRUs return f32, which their caller
casts (`sstts_torch.model.modules.CBHG`).
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
    """Fused-gate GRU step: (x (B, D), h (B, H)) -> new h (B, H), computed
    in f32 and returned in the compute dtype."""

    def __init__(self, d_in: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(d_in, features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        dt = self.wx.dtype
        return gru_step_math(x.to(dt), h.to(dt), self.wx, self.wh, self.b).to(self.dtype)


class UnidirectionalGRU(_GRUParams):
    """(B, T, D), optional (B, T) mask -> (B, T, H) f32; `reverse` scans
    right to left with outputs in the original order; the carry freezes on
    padding."""

    def __init__(self, d_in: int, features: int, reverse: bool = False):
        super().__init__(d_in, features)
        self.reverse = reverse

    def forward(
        self, xs: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return gru_sequence(xs, self.wx, self.wh, self.b, mask, self.reverse)


class BiGRU(nn.Module):
    """Bidirectional GRU: concat(forward, backward) -> (B, T, 2H) f32.  The
    input is masked before both directions."""

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
