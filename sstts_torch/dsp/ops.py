"""Pre-emphasis, dB conversions, block-parallel de-emphasis and the
feature pipeline.

Port of `sstts/dsp/ops.py:24-28` (pre-emphasis), `30-83` (de-emphasis),
`99-113` (dB ops) and `618-651` (`wav_to_features` with
`fft_impl="default"`).  The direct-DFT feature transforms ("dft_*") are not
ported (ROADMAP A.6).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from sstts_torch.config import DatasetConfig
from sstts_torch.dsp import mel as mel_mod
from sstts_torch.dsp import stft as stft_mod

_DFT_IMPLS = ("dft_default", "dft_high", "dft_highest")


def preemphasis(y: torch.Tensor, coeff: float) -> torch.Tensor:
    """y'[t] = y[t] - coeff * y[t-1] (y'[0] = y[0]), over the last dim."""
    return y - coeff * torch.nn.functional.pad(y[..., :-1], (1, 0))


def magnitude_to_decibel(x: torch.Tensor) -> torch.Tensor:
    """20 * log10(max(1e-5, x))."""
    return 20.0 * torch.log10(torch.clamp(x, min=1e-5))


def decibel_to_magnitude(db: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, db / 20.0)


def normalize_decibel(db: torch.Tensor, ref_db: float, min_db: float) -> torch.Tensor:
    return torch.clamp((db - ref_db - min_db) / (-min_db), 0.0, 1.0)


def inv_normalize_decibel(s: torch.Tensor, ref_db: float, min_db: float) -> torch.Tensor:
    return torch.clamp(s, 0.0, 1.0) * (-min_db) + min_db + ref_db


@functools.lru_cache(maxsize=None)
def _deemphasis_matrices(coeff: float, block: int, n_blocks: int):
    """Host constants: the in-block zero-state response (Toeplitz, transposed
    for `x @ T`), the block-carry matrix and the in-block decay ramp."""
    i = np.arange(block)
    toeplitz = np.where(
        i[:, None] >= i[None, :],
        np.power(float(coeff), (i[:, None] - i[None, :]).astype(np.float64)),
        0.0,
    ).astype(np.float32)
    # Block boundary states s_b = decay * s_{b-1} + e_b, unrolled:
    # s_b = sum_{c <= b} decay^(b-c) e_c.
    decay = float(coeff) ** block
    bb = np.arange(n_blocks)
    lag = bb[:, None] - bb[None, :]
    with np.errstate(under="ignore"):
        carry = np.where(
            lag >= 0, np.power(decay, np.maximum(lag, 0).astype(np.float64)), 0.0
        ).astype(np.float32)
    ramp = (float(coeff) ** np.arange(1, block + 1, dtype=np.float64)).astype(
        np.float32
    )
    return toeplitz.T.copy(), carry.T.copy(), ramp


def deemphasis(y: torch.Tensor, coeff: float, block: int = 256) -> torch.Tensor:
    """Inverse IIR x[t] = y[t] + coeff * x[t-1], block-parallel, in f32.

    Within a block the zero-state response is one lower-triangular Toeplitz
    matmul; the block boundary states follow s_b = coeff^block * s_{b-1} +
    e_b, a short recurrence over the blocks taken here as one small
    triangular matmul (its decay powers underflow to exact zeros after a few
    blocks, as the scan's products do).
    """
    if coeff == 0.0:
        return y.float()
    n = y.shape[-1]
    n_blocks = -(-n // block)
    pad = n_blocks * block - n
    x = torch.nn.functional.pad(y.float(), (0, pad))
    batch = x.shape[:-1]
    x = x.reshape(*batch, n_blocks, block)
    toeplitz_t, carry_t, ramp = (
        torch.as_tensor(a, device=y.device)
        for a in _deemphasis_matrices(float(coeff), block, n_blocks)
    )
    zs = x @ toeplitz_t
    s = zs[..., -1] @ carry_t  # (..., n_blocks)
    s_prev = torch.nn.functional.pad(s[..., :-1], (1, 0))
    out = zs + s_prev[..., None] * ramp
    return out.reshape(*batch, n_blocks * block)[..., :n]


def wav_to_features(
    y: torch.Tensor, cfg: DatasetConfig, fft_impl: str = "default"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n_samples) waveform -> (linear (..., n_frames, n_fft//2+1),
    mel (..., n_frames, n_mels)), both normalized to [0, 1]; one STFT feeds
    both."""
    if fft_impl in _DFT_IMPLS:
        raise NotImplementedError(
            f"feature fft_impl={fft_impl!r} is not ported yet (ROADMAP A.6: "
            "direct-DFT features); use 'default'"
        )
    if fft_impl != "default":
        raise ValueError(
            f"unknown fft_impl {fft_impl!r}; valid: 'default', "
            + ", ".join(repr(k) for k in _DFT_IMPLS)
        )
    y = preemphasis(y.float(), cfg.preemphasis)
    mag = stft_mod.stft(y, cfg.n_fft, cfg.hop_len, cfg.win_len).abs()
    linear = normalize_decibel(magnitude_to_decibel(mag), cfg.ref_level_db, cfg.min_level_db)
    mel = normalize_decibel(
        magnitude_to_decibel(mel_mod.apply_mel(mag, cfg)), cfg.ref_level_db, cfg.min_level_db
    )
    return linear, mel
