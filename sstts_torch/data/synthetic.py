"""Deterministic synthetic corpus: the port of `sstts/data/synthetic.py`
(22-61).

Pseudo-sentences over the real charset, paired with multi-tone waveforms
whose spectral content follows the text: an LJSpeech-shaped corpus for
tests, smoke training and measurements, with no files.  `synth_waveform`
seeds its noise from `hash(uid)`, which Python salts per process, exactly
as the JAX package does: the tones are deterministic, the 1% noise floor is
not, so a comparison across processes feeds one generated array to both
sides.
"""

from __future__ import annotations

from typing import List

import numpy as np

from sstts_torch.config import DatasetConfig
from sstts_torch.data.ljspeech import Utterance

_WORDS = (
    "the quick brown fox jumps over a lazy dog while printing reports "
    "on speech synthesis with tacotron style models for the tpu native "
    "framework that reconstructs audio from mel spectrograms very well"
).split()


def make_utterances(
    n: int, cfg: DatasetConfig, min_words: int = 4, max_words: int = 12
) -> List[Utterance]:
    rng = np.random.default_rng(42)
    utts = []
    for i in range(n):
        k = int(rng.integers(min_words, max_words + 1))
        words = rng.choice(_WORDS, size=k)
        utts.append(Utterance(f"SYN-{i:05d}", f"<synthetic:{i}>", " ".join(words)))
    return utts


def synth_waveform(uid: str, text: str, cfg: DatasetConfig) -> np.ndarray:
    """Deterministic tone sequence for an utterance: one fundamental per
    character, 60 ms each, so text and audio lengths correlate."""
    rng = np.random.default_rng(abs(hash(uid)) % 2**32)
    sr = cfg.sample_rate
    char_dur = int(0.06 * sr)
    segs = []
    phase = 0.0
    for c in text:
        f0 = 110.0 + 12.0 * (ord(c) % 32)
        t = np.arange(char_dur) / sr
        seg = 0.4 * np.sin(2 * np.pi * f0 * t + phase)
        seg += 0.15 * np.sin(2 * np.pi * 2 * f0 * t + phase)
        phase += 2 * np.pi * f0 * char_dur / sr
        segs.append(seg)
    y = np.concatenate(segs) if segs else np.zeros(char_dur)
    y += 0.01 * rng.standard_normal(len(y))
    return y.astype(np.float32)
