"""Window-folded, support-reduced real-DFT matrices.

Port of `sstts/dsp/fft.py:_rdft_matrices_windowed` (318-352).  The phase is
computed as `(t * k) mod n` in integers and only then scaled to radians in
float32, so large `t * k` products lose no precision.
"""

from __future__ import annotations

import numpy as np
import torch


def rdft_matrices_windowed(n: int, window: np.ndarray, device=None):
    """Returns (lo, w_len, cos_w (w_len, h), nsin_w (w_len, h),
    inv_re_w (h, w_len), inv_im_w (h, w_len)), f32 on `device`.

    [lo, lo + w_len) is the window's support; the analysis matrices carry
    the window on their rows and the synthesis matrices the window and the
    inverse-rDFT weights (1/n at DC and Nyquist, 2/n elsewhere).
    """
    window = np.asarray(window, dtype=np.float32)
    nz = np.nonzero(window)[0]
    lo, hi = int(nz[0]), int(nz[-1]) + 1
    w_len = hi - lo
    half = n // 2 + 1
    t = lo + torch.arange(w_len, dtype=torch.int64, device=device)[:, None]
    k = torch.arange(half, dtype=torch.int64, device=device)[None, :]
    phase = ((t * k) % n).to(torch.float32) * np.float32(2.0 * np.pi / n)
    cos = torch.cos(phase)
    nsin = -torch.sin(phase)
    wvals = torch.as_tensor(window[lo:hi], device=device)[:, None]
    cos_w = cos * wvals
    nsin_w = nsin * wvals
    w = np.full(half, 2.0, np.float32)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    w_col = torch.as_tensor(w, device=device)[:, None] * np.float32(1.0 / n)
    inv_re_w = (w_col * cos.T) * wvals.T
    inv_im_w = (w_col * nsin.T) * wvals.T
    return lo, w_len, cos_w, nsin_w, inv_re_w, inv_im_w
