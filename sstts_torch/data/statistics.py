"""Corpus feature statistics: the port of `sstts/data/statistics.py`.

Per-corpus dB distributions of the linear and mel spectrograms, to check
the normalization range (`ref_level_db` / `min_level_db`) against real
data.  The spectrograms are computed on the device, an utterance a call,
and reduced there; only the reductions reach the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sstts_torch.config import Config
from sstts_torch.data import pipeline as pipeline_mod
from sstts_torch.data.ljspeech import Utterance
from sstts_torch.dsp import mel as mel_mod
from sstts_torch.dsp import ops
from sstts_torch.dsp import stft as stft_mod
from sstts_torch.synthesize import exact_f32, resolve_device


def featurize_db(y: torch.Tensor, cfg: Config):
    """Waveform -> (linear dB, mel dB) before normalization."""
    ds = cfg.dataset
    y = ops.preemphasis(y.float(), ds.preemphasis)
    mag = stft_mod.stft(y, ds.n_fft, ds.hop_len, ds.win_len).abs()
    return ops.magnitude_to_decibel(mag), ops.magnitude_to_decibel(mel_mod.apply_mel(mag, ds))


def compute_statistics(
    utts: Sequence[Utterance],
    cfg: Config,
    limit: Optional[int] = 256,
    device=None,
) -> Dict[str, float]:
    """dB statistics over (up to `limit`) utterances, on `device` (None:
    the card).

    Returns min/max/mean for linear and mel dB (before normalization) and
    the fractions of normalized linear values that clip at 0 or 1: if
    either is large, the configured dB range does not fit the corpus.
    """
    dev = resolve_device(device)
    ds = cfg.dataset
    lin_stats = []
    mel_stats = []
    clip_lo = clip_hi = total = 0
    with torch.no_grad(), exact_f32(dev):
        for u in list(utts)[: limit or len(utts)]:
            audio = pipeline_mod.load_audio(u, cfg)
            if len(audio) < ds.win_len:
                continue
            lin_db, mel_db = featurize_db(torch.from_numpy(audio).to(dev), cfg)
            norm = (lin_db - ds.ref_level_db - ds.min_level_db) / (-ds.min_level_db)
            row = torch.stack([t.double() for t in (
                lin_db.min(), lin_db.max(), lin_db.mean(),
                mel_db.min(), mel_db.max(), mel_db.mean(),
                (norm <= 0).sum(), (norm >= 1).sum(),
            )]).cpu().numpy()
            lin_stats.append(row[0:3])
            mel_stats.append(row[3:6])
            clip_lo += int(row[6])
            clip_hi += int(row[7])
            total += norm.numel()
    if not lin_stats:
        raise ValueError("no usable utterances for statistics")
    lin = np.asarray(lin_stats)
    mel = np.asarray(mel_stats)
    return {
        "n_utterances": float(len(lin_stats)),
        "linear_db_min": float(lin[:, 0].min()),
        "linear_db_max": float(lin[:, 1].max()),
        "linear_db_mean": float(lin[:, 2].mean()),
        "mel_db_min": float(mel[:, 0].min()),
        "mel_db_max": float(mel[:, 1].max()),
        "mel_db_mean": float(mel[:, 2].mean()),
        "clip_frac_low": clip_lo / max(total, 1),
        "clip_frac_high": clip_hi / max(total, 1),
    }
