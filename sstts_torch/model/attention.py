"""Attention mechanisms for the decoder: the port of
`sstts/model/attention.py` (22-128): Bahdanau (additive) and the windowed
local-Luong (multiplicative) attention, chosen by `make_attention`.

Parameters stay f32; under a bf16 compute dtype the inputs and weights are
cast at use, as flax's `dtype=` does, and `masked_softmax` upcasts the
scores to f32.  Both take the previous alignment; Bahdanau ignores it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

_NEG_INF = -1e9


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last dim in f32, masked positions at -1e9."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    return torch.softmax(scores, dim=-1)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax's `nn.Dense(dtype=...)`: input, kernel and bias cast to the
    compute dtype, the product in it."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


class BahdanauAttention(nn.Module):
    """Additive attention: v . tanh(keys + W_q q + b); `init_keys` projects
    the encoder memory once per utterance."""

    def __init__(self, memory_dim: int, query_dim: int, units: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.memory_proj = nn.Linear(memory_dim, units, bias=False)
        self.query_proj = nn.Linear(query_dim, units, bias=False)
        self.b = nn.Parameter(torch.zeros(units))
        self.v = nn.Parameter(torch.empty(units))

    def init_keys(self, memory: torch.Tensor) -> torch.Tensor:
        """(B, T, Dm) -> (B, T, A)."""
        return linear(memory, self.memory_proj, self.dtype)

    def forward(
        self,
        query: torch.Tensor,
        keys: torch.Tensor,
        mask: Optional[torch.Tensor],
        prev_alignment: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        del prev_alignment  # content-based: history-free
        q = linear(query, self.query_proj, self.dtype)[:, None, :]
        s = torch.tanh(keys + q + self.b.to(self.dtype))
        scores = torch.einsum("bta,a->bt", s, self.v.to(self.dtype))
        return masked_softmax(scores, mask)


class LocalLuongAttention(nn.Module):
    """Windowed multiplicative attention: scores q . W m / sqrt(units),
    restricted to |position - expected position of the previous alignment|
    <= `window` (static shapes; the window is a mask)."""

    def __init__(self, memory_dim: int, query_dim: int, units: int, window: int = 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.units = units
        self.window = window
        self.dtype = dtype
        self.memory_proj = nn.Linear(memory_dim, units, bias=False)
        self.query_proj = nn.Linear(query_dim, units, bias=False)

    def init_keys(self, memory: torch.Tensor) -> torch.Tensor:
        return linear(memory, self.memory_proj, self.dtype)

    def forward(
        self,
        query: torch.Tensor,
        keys: torch.Tensor,
        mask: Optional[torch.Tensor],
        prev_alignment: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        q = linear(query, self.query_proj, self.dtype)
        # The reference divides by an f32 array: the scores leave the
        # compute dtype here.
        scores = torch.einsum("ba,bta->bt", q, keys).float() / math.sqrt(self.units)
        if prev_alignment is not None:
            t_len = keys.shape[1]
            positions = torch.arange(t_len, device=keys.device, dtype=torch.float32)[None]
            center = (prev_alignment.float() * positions).sum(-1, keepdim=True)
            in_window = torch.abs(positions - center) <= float(self.window)
            mask = in_window if mask is None else mask & in_window
        return masked_softmax(scores, mask)


def attention_context(alignment: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """(B, T) alignment x (B, T, D) memory -> (B, D) context, in the wider
    of the two dtypes (the alignment is f32 from the softmax)."""
    dt = torch.promote_types(alignment.dtype, memory.dtype)
    return torch.einsum("bt,btd->bd", alignment.to(dt), memory.to(dt))


def make_attention(kind: str, memory_dim: int, query_dim: int, units: int,
                   dtype: torch.dtype = torch.float32, window: int = 16) -> nn.Module:
    if kind == "bahdanau":
        return BahdanauAttention(memory_dim, query_dim, units, dtype)
    if kind == "local_luong":
        return LocalLuongAttention(memory_dim, query_dim, units, window, dtype)
    raise ValueError(f"unknown attention type: {kind}")
