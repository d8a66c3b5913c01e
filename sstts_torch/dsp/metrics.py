"""Audio quality metrics on the host (numpy): a copy of
`sstts/dsp/metrics.py`, so the port imports nothing of the JAX package.

* `mcd_db`: mel-cepstral distortion with cepstral truncation (the DCT
  keeps the spectral envelope, so noise in the inter-harmonic valleys
  cannot pass for an improvement, as it can in dB-domain mel-L1).
* `mcd_from_normalized_mel`: the same from the pipeline's [0, 1] mel.
* `peak_masked_l1_db`: dB L1 over the bins within `top_db` of each frame's
  peak in the reference.
* `spectral_snr_db`: magnitude-spectrogram SNR, phase-insensitive.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "mcd_db",
    "mcd_from_normalized_mel",
    "peak_masked_l1_db",
    "spectral_snr_db",
]


def _dct2_rows(n_mels: int, n_coeffs: int) -> np.ndarray:
    """Orthonormal DCT-II analysis rows for cepstra 1..n_coeffs (c0 — the
    frame energy — is dropped, standard MCD practice)."""
    k = np.arange(1, n_coeffs + 1, dtype=np.float64)[:, None]
    n = np.arange(n_mels, dtype=np.float64)[None, :]
    return np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_mels)) * np.sqrt(
        2.0 / n_mels
    )


def mcd_db(
    mel_db_a: np.ndarray, mel_db_b: np.ndarray, n_coeffs: int = 13
) -> float:
    """Mel-cepstral distortion (dB) between two log-mel arrays in dB units,
    shape (..., frames, n_mels); mean over all frames.

    Cepstra are DCT-II of the dB log-mel.  Calibration: the classic
    Kubichek MCD is (10/ln 10) * sqrt(2 * sum_d dc_d^2) over NATURAL-log
    cepstra; dB values are (20/ln 10) x natural log, so the same quantity
    from dB-domain cepstra is ||dc_db||_2 / sqrt(2) per frame (the DCT is
    linear, the scale factors cancel to 1/sqrt(2)).  Computed from the
    pipeline's 80-band log-mel, not WORLD/SPTK MGC — the standard
    neural-TTS evaluation form.
    """
    a = np.asarray(mel_db_a, np.float64)
    b = np.asarray(mel_db_b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    M = _dct2_rows(a.shape[-1], n_coeffs)
    dc = (a - b) @ M.T
    per_frame = np.sqrt((dc**2).sum(-1)) / np.sqrt(2.0)
    return float(per_frame.mean())


def mcd_from_normalized_mel(
    mel_norm_a: np.ndarray,
    mel_norm_b: np.ndarray,
    min_level_db: float = -100.0,
    n_coeffs: int = 13,
) -> float:
    """MCD from the pipeline's NORMALIZED mel features ([0, 1] scale).

    `normalize_decibel` is affine — norm = (db - ref - min) / (-min) — so
    dB-unit cepstral distances are the normalized-domain distances scaled
    by (-min_level_db); the ref/min offsets cancel in the difference.
    """
    scale = -float(min_level_db)
    return mcd_db(
        np.asarray(mel_norm_a) * scale,
        np.asarray(mel_norm_b) * scale,
        n_coeffs=n_coeffs,
    )


def peak_masked_l1_db(
    ref_db: np.ndarray,
    test_db: np.ndarray,
    top_db: float = 25.0,
    silence_db: float = 60.0,
) -> float:
    """dB-domain L1 restricted to bins within `top_db` of each frame's max
    in the REFERENCE — the harmonic-peak / formant regions where the
    signal dominates any noise floor.

    This is the gate-grade valley-fill-robust metric: broadband
    quantization noise lives ~30+ dB below the peaks it would need to
    perturb, so it cannot LOWER this metric the way it lowers mel-L1
    (and, measured in the round-5 gate smoke runs, partially lowers MCD
    too — the fill is partly envelope-scale, which cepstral truncation
    keeps).  A lossless wire is optimal here by construction; lossy
    codecs can only match it (error at peaks ~0) or exceed it.

    Frames whose own peak sits more than `silence_db` below the GLOBAL
    reference peak are excluded entirely: a silence/padding frame has no
    harmonic peak to preserve, and its "peak mask" is just the dB floor —
    including it would measure each codec's noise floor in silence (a
    fixed-step codec like mu-law reads catastrophically there while a
    block-adaptive one reads clean), which is the idle-channel-noise
    question, not the does-the-wire-preserve-the-signal question this
    metric gates.
    """
    r = np.asarray(ref_db, np.float64)
    t = np.asarray(test_db, np.float64)
    if r.shape != t.shape:
        raise ValueError(f"shape mismatch {r.shape} vs {t.shape}")
    frame_peak = r.max(-1, keepdims=True)
    mask = (r >= frame_peak - float(top_db)) & (
        frame_peak >= r.max() - float(silence_db)
    )
    if not mask.any():
        raise ValueError("no frames above the silence threshold")
    return float(np.abs(r - t)[mask].mean())


def spectral_snr_db(mag_ref: np.ndarray, mag_test: np.ndarray) -> float:
    """10*log10(E[|S_ref|^2] / E[(|S_test| - |S_ref|)^2]) over magnitude
    spectrograms — phase-insensitive, so it can measure Griffin-Lim's own
    reconstruction error (waveform SNR cannot: GL phase differs sample-
    wise from the ground truth even at perfect magnitudes)."""
    r = np.asarray(mag_ref, np.float64)
    t = np.asarray(mag_test, np.float64)
    if r.shape != t.shape:
        raise ValueError(f"shape mismatch {r.shape} vs {t.shape}")
    err = float(((t - r) ** 2).mean())
    sig = float((r**2).mean())
    return 10.0 * np.log10(sig / max(err, 1e-300))
