"""Text ids: the model's character table (PAD "_" is 0, EOS "~" is 1, then
lowercase letters, digits, space and punctuation) and its encoding of a
lowercase text without digits or abbreviations, as the benchmark's
traffic makes them: the characters' ids and one EOS."""

from __future__ import annotations

from typing import List, Sequence

import torch

CHARSET = "_~abcdefghijklmnopqrstuvwxyz0123456789 !'\"(),-.:;?"
_ID = {c: i for i, c in enumerate(CHARSET)}


def encode(text: str) -> List[int]:
    """The ids of a normalised text (single spaces, lowercase) and EOS."""
    return [_ID[c] for c in " ".join(text.lower().split())] + [1]


def batch_ids(texts: Sequence[str], device=None) -> torch.Tensor:
    """(B, T) int64 ids, zero-padded to the longest."""
    enc = [encode(t) for t in texts]
    out = torch.zeros(len(enc), max(map(len, enc)), dtype=torch.long)
    for i, e in enumerate(enc):
        out[i, : len(e)] = torch.tensor(e)
    return out.to(device)
