"""Bahdanau attention: the port of `sstts/model/attention.py` (22-70,
112-116).  The local-Luong variant is not part of this port yet (ROADMAP
queue A)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

_NEG_INF = -1e9


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax over the last dim in f32, masked positions at -1e9."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    return torch.softmax(scores, dim=-1)


class BahdanauAttention(nn.Module):
    """Additive attention: v . tanh(keys + W_q q + b); `init_keys` projects
    the encoder memory once per utterance."""

    def __init__(self, memory_dim: int, query_dim: int, units: int):
        super().__init__()
        self.memory_proj = nn.Linear(memory_dim, units, bias=False)
        self.query_proj = nn.Linear(query_dim, units, bias=False)
        self.b = nn.Parameter(torch.zeros(units))
        self.v = nn.Parameter(torch.empty(units))

    def init_keys(self, memory: torch.Tensor) -> torch.Tensor:
        """(B, T, Dm) -> (B, T, A)."""
        return self.memory_proj(memory)

    def forward(
        self,
        query: torch.Tensor,
        keys: torch.Tensor,
        mask: Optional[torch.Tensor],
    ) -> torch.Tensor:
        q = self.query_proj(query)[:, None, :]
        s = torch.tanh(keys + q + self.b)
        scores = torch.einsum("bta,a->bt", s, self.v)
        return masked_softmax(scores, mask)


def attention_context(alignment: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
    """(B, T) alignment x (B, T, D) memory -> (B, D) context."""
    return torch.einsum("bt,btd->bd", alignment, memory)
