"""The inference prenet dropout's keep rule (Tacotron-1 keeps it on at
inference): one int32 seed a batch; at decode step t a unit j of prenet
layer l in global row b is kept where word 0 of Philox4x32-10 (Salmon et
al., SC 2011) with counter (j, b, l, 0) and key ((seed + t) mod 2^32, 0)
is at least min(rate 2^32, 2^32 - 1); kept units scale by 1 / (1 - rate).
In int64 tensor ops, the 32 x 32 products from 16-bit halves."""

from __future__ import annotations

from typing import List, Optional

import torch

_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    al, ah = a & 0xFFFF, a >> 16
    ml, mh = m & 0xFFFF, m >> 16
    ll, lh, hl = al * ml, al * mh, ah * ml
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (ah * mh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & _U32
    return hi, lo


def philox_word0(counter, key) -> torch.Tensor:
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for i in range(10):
        if i:
            k0, k1 = (k0 + _W[0]) & _U32, (k1 + _W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _M[0])
        hi1, lo1 = _mulhilo(c2, _M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def keep_masks(seed: Optional[int], rows: torch.Tensor, steps: int, units, rate: float,
               device=None) -> Optional[List[torch.Tensor]]:
    """Per prenet layer a (steps, len(rows), P) float {0, 1} mask for the
    global rows `rows`, or None without dropout."""
    if seed is None or rate <= 0.0:
        return None
    threshold = int(min(min(max(rate, 0.0), 1.0) * 4294967296.0, 4294967295.0))
    kw = dict(dtype=torch.int64, device=device)
    t = torch.arange(steps, **kw)[:, None, None]
    row = torch.as_tensor(rows, **kw)[None, :, None]
    out = []
    for layer, p in enumerate(units):
        unit = torch.arange(p, **kw)[None, None, :]
        bits = philox_word0((unit, row, layer, 0), ((seed + t) & _U32, 0))
        out.append((bits >= threshold).float())
    return out


def dropout_scale(rate: float) -> float:
    return 1.0 / (1.0 - rate) if rate < 1.0 else 0.0
