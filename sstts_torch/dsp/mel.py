"""Slaney mel filterbank: the port of `sstts/dsp/reference.py` (88-133,
`hz_to_mel`, `mel_to_hz`, `mel_filterbank`) and `sstts/dsp/mel.py` (21-40).

The filterbank is built once on the host in float64 numpy (librosa's
`htk=False` semantics; a copy, so the port never imports the JAX package)
and applied on the device as one (bins -> n_mels) f32 matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sstts_torch.config import DatasetConfig

_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(frequencies) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(frequencies, dtype=np.float64)
    return np.where(
        f >= _MIN_LOG_HZ,
        _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        f / _F_SP,
    )


def mel_to_hz(mels) -> np.ndarray:
    m = np.asarray(mels, dtype=np.float64)
    return np.where(
        m >= _MIN_LOG_MEL,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
        _F_SP * m,
    )


def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (n_mels, n_fft//2 + 1),
    float64."""
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney-style normalization: each filter integrates to ~2 / bandwidth.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    return weights * enorm[:, None]


@functools.lru_cache(maxsize=None)
def _filterbank_np(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float
) -> np.ndarray:
    return mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax).astype(np.float32)


def filterbank(cfg: DatasetConfig, device=None) -> torch.Tensor:
    """(n_mels, n_fft//2+1) float32 filterbank for `cfg` on `device`."""
    fb = _filterbank_np(cfg.sample_rate, cfg.n_fft, cfg.n_mels, cfg.mel_fmin, cfg.mel_fmax)
    return torch.as_tensor(fb, device=device)


def apply_mel(magnitude: torch.Tensor, cfg: DatasetConfig) -> torch.Tensor:
    """(..., frames, bins) linear magnitude -> (..., frames, n_mels)."""
    return magnitude @ filterbank(cfg, magnitude.device).T
