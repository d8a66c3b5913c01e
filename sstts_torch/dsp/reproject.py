"""Banded frames-domain reprojection for the Griffin-Lim loop.

Port of `sstts/dsp/reproject.py:43-157`.  Between the two DFT GEMMs of a
Griffin-Lim iteration, overlap-add -> window-sum normalise -> reflect pad ->
re-frame collapses into a banded shift-add over the synthesis frames F:

    F'[t, j] = inv_wss[lo + t*hop + j] * sum_{d=-D..D} F[t - d, j + d*hop],

plus mirrored copies (librosa's reflect padding) at the few edge positions
whose sample index falls outside the signal.  `band_plan` is a copy of the
JAX package's host-side plan (`_band_plan`), so the port needs none of it.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sstts_torch.dsp.stft import hann_window, pad_center


@functools.lru_cache(maxsize=None)
def band_plan(
    n_fft: int, hop: int, win_length: int, n_frames: int, length: int
) -> dict:
    """Static host-side plan: geometry, normalization, mirror runs.

    Returns host numpy only (cached).  `wss2d[t, j]` is the inverse
    window-sum envelope at frame position (t, j), zeroed outside the
    signal; each run (t, a, b, t_src, src_lo, src_hi) sets
    out[t, a:b] = flip(out[t_src, src_lo:src_hi]).
    """
    window = pad_center(hann_window(win_length), n_fft).astype(np.float64)
    nz = np.nonzero(window)[0]
    lo, hi = int(nz[0]), int(nz[-1]) + 1
    w_len = hi - lo
    start = n_fft // 2 - lo
    d_max = (w_len - 1) // hop
    t_idx = np.arange(n_frames)

    w2 = window**2
    total = (n_frames - 1) * hop + n_fft
    wss = np.zeros(total, np.float64)
    for i in range(n_frames):
        wss[i * hop : i * hop + n_fft] += w2
    inv_full = np.where(wss > 1e-10, 1.0 / np.maximum(wss, 1e-10), 1.0)
    pos = lo + t_idx[:, None] * hop + np.arange(w_len)[None, :]  # (T, w_len)
    s = pos - n_fft // 2  # signal sample index at each frame position
    wss2d = inv_full[pos] * ((s >= 0) & (s < length))

    runs: List[Tuple[int, int, int, int, int, int]] = []

    def add_runs(t: int, js: np.ndarray, u_mirror: np.ndarray) -> None:
        if js.size == 0:
            return
        t_src = np.minimum(n_frames - 1, u_mirror // hop)
        j_src = u_mirror - t_src * hop
        # group contiguous j with equal t_src (j_src then descends by 1)
        cut = np.flatnonzero(np.diff(t_src)) + 1
        for grp_j, grp_src_t, grp_src_j in zip(
            np.split(js, cut), np.split(t_src, cut), np.split(j_src, cut)
        ):
            runs.append(
                (
                    t,
                    int(grp_j[0]),
                    int(grp_j[-1]) + 1,
                    int(grp_src_t[0]),
                    int(grp_src_j[-1]),
                    int(grp_src_j[0]) + 1,
                )
            )

    U = start + length
    for t in range(n_frames):
        u = t * hop + np.arange(w_len)
        left = np.flatnonzero(u < start)
        if left.size:
            add_runs(t, left, 2 * start - u[left])
        right = np.flatnonzero(u >= U)
        if right.size:
            add_runs(t, right, 2 * (U - 1) - u[right])

    return {
        "lo": lo,
        "w_len": w_len,
        "start": start,
        "d_max": d_max,
        "wss2d": wss2d.astype(np.float32),
        "runs": tuple(runs),
    }


def padded_wss2d(plan: dict, wp: int, device) -> torch.Tensor:
    """`plan["wss2d"]` zero-padded to `wp` lanes, f32 on `device`."""
    wss = torch.as_tensor(plan["wss2d"], device=device)
    return F.pad(wss, (0, wp - plan["w_len"]))


def apply_mirror_runs(out: torch.Tensor, runs) -> torch.Tensor:
    """Overwrite the edge positions with their reflect-pad mirrors, in run
    order (a run may read a row an earlier run wrote).  In place."""
    for t, a, b, t_src, src_lo, src_hi in runs:
        out[..., t, a:b] = out[..., t_src, src_lo:src_hi].flip(-1)
    return out


def shift_add_rows(
    frames: torch.Tensor,
    w_len: int,
    hop: int,
    d_max: int,
    rows_lo: int,
    rows_hi: int,
) -> torch.Tensor:
    """sum_d F[t - d, j + d*hop] for rows [rows_lo, rows_hi), f32.

    `frames` is (..., n_frames, wp) with wp >= w_len; source lanes outside
    the window support [0, w_len) and rows outside [0, n_frames) count as
    zero.  The terms are summed d = 0 first, then d = -D..D without 0, the
    order of the Pallas kernel and of its CUDA port.
    """
    n_frames, wp = frames.shape[-2], frames.shape[-1]
    col_pad = d_max * hop
    g_lo = max(0, rows_lo - d_max)
    g_hi = min(n_frames, rows_hi + d_max)
    f1 = frames[..., g_lo:g_hi, :w_len].float()
    top = g_lo - (rows_lo - d_max)
    bot = (rows_hi + d_max) - g_hi
    f1 = F.pad(f1, (col_pad, col_pad + wp - w_len, top, bot))
    H = rows_hi - rows_lo

    def term(d):
        return f1[
            ...,
            d_max - d : d_max - d + H,
            col_pad + d * hop : col_pad + d * hop + wp,
        ]

    acc = term(0)
    for d in range(-d_max, d_max + 1):
        if d:
            acc = acc + term(d)
    return acc
