"""Sample-rate conversion for corpus preparation: a copy of
`sstts/dsp/resample.py`, so the port imports nothing of the JAX package.

A dependency-free Kaiser-windowed-sinc polyphase resampler on the host
(numpy), for a 16 kHz or 48 kHz corpus read into the 22.05 kHz pipeline
(`dataset.resample_on_load`).  Corpus preparation is one-off work, not a
training-loop hot path.
"""

from __future__ import annotations

import math

import numpy as np


def resample(
    y: np.ndarray, orig_sr: int, target_sr: int, num_zeros: int = 32
) -> np.ndarray:
    """Resample 1-D audio with a Kaiser-windowed-sinc polyphase filter."""
    if orig_sr == target_sr:
        return np.asarray(y, dtype=np.float32)
    if orig_sr <= 0 or target_sr <= 0:
        raise ValueError(f"invalid sample rates {orig_sr} -> {target_sr}")
    y = np.asarray(y, dtype=np.float64)
    g = math.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    # Anti-aliasing cutoff at the lower Nyquist.
    cutoff = min(1.0 / up, 1.0 / down)
    half_len = num_zeros * max(up, down)
    n = np.arange(-half_len, half_len + 1)
    taps = cutoff * np.sinc(cutoff * n) * np.kaiser(len(n), 12.0) * up
    # Polyphase: upsample by `up` (zero-stuff), filter, downsample by `down`.
    out_len = int(np.ceil(len(y) * up / down))
    out = np.zeros(out_len, dtype=np.float64)
    # For each output sample m: t = m * down / up in input coordinates.
    m = np.arange(out_len)
    t_in = m * down / up
    base = np.floor(t_in).astype(np.int64)
    frac = t_in - base
    # Evaluate the filter at offsets (k - frac) for k in [-K, K] in input units.
    K = num_zeros
    acc = np.zeros(out_len)
    for k in range(-K, K + 1):
        idx = base + k
        valid = (idx >= 0) & (idx < len(y))
        # taps index: position (k - frac) * up within the prototype filter.
        tap_pos = np.round((k - frac) * up).astype(np.int64) + half_len
        tap_ok = (tap_pos >= 0) & (tap_pos < len(taps))
        w = np.where(tap_ok, taps[np.clip(tap_pos, 0, len(taps) - 1)], 0.0)
        acc += np.where(valid, y[np.clip(idx, 0, len(y) - 1)], 0.0) * w
    return acc.astype(np.float32)
