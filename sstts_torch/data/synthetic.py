"""Deterministic synthetic corpus: the port of `sstts/data/synthetic.py`
(22-61).

Pseudo-sentences over the real charset, paired with multi-tone waveforms
whose spectral content follows the text: an LJSpeech-shaped corpus for
tests, smoke training and measurements, with no files.  `synth_waveform`
seeds its noise from `hash(uid)`, which Python salts per process, exactly
as the JAX package does: the tones are deterministic, the 1% noise floor is
not, so a comparison across processes feeds one generated array to both
sides.  `materialize_corpus` writes such a corpus to disk as an LJSpeech-,
Blizzard-Nancy- or CSS10-layout tree of PCM16 WAV files, for the loaders'
tests and the command-line path's smoke run.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional

import numpy as np

from sstts_torch.config import DatasetConfig
from sstts_torch.data import wav as wav_mod
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
    return _tones(uid, text, cfg.sample_rate)


def _tones(uid: str, text: str, sr: int) -> np.ndarray:
    rng = np.random.default_rng(abs(hash(uid)) % 2**32)
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


def materialize_corpus(
    root: str | Path,
    n: int,
    cfg: DatasetConfig,
    layout: str = "ljspeech",
    sample_rate: Optional[int] = None,
    pad_s: float = 0.0,
    min_words: int = 4,
    max_words: int = 12,
) -> Path:
    """Write `n` synthetic utterances under `root` as an on-disk corpus:
    "ljspeech" (`metadata.csv` + `wavs/`, as `sstts/data/synthetic.py`
    writes it), "blizzard_nancy" (`prompts.data` + `wavn/`) or "css10"
    (`transcript.txt` + `<book>/<n>.wav`).  WAVs are PCM16 at
    `sample_rate` (default `cfg.sample_rate`) with `pad_s` seconds of
    silence at each end, which trimming removes."""
    root = Path(root)
    sr = sample_rate or cfg.sample_rate
    pad = np.zeros(int(pad_s * sr), np.float32)
    utts = make_utterances(n, cfg, min_words, max_words)
    lines = []
    for i, u in enumerate(utts):
        y = np.concatenate([pad, _tones(u.uid, u.text, sr), pad])
        if layout == "ljspeech":
            path = root / "wavs" / f"{u.uid}.wav"
            lines.append(f"{u.uid}|{u.text}|{u.text}")
        elif layout == "blizzard_nancy":
            path = root / "wavn" / f"{u.uid}.wav"
            lines.append(f'( {u.uid} "{u.text.capitalize()}." )')
        elif layout == "css10":
            rel = f"book{i % 2}/{i}.wav"
            path = root / rel
            lines.append(f"{rel}|{u.text.capitalize()}.|{u.text}.|{len(y) / sr:.2f}")
        else:
            raise ValueError(f"unknown corpus layout {layout!r}")
        path.parent.mkdir(parents=True, exist_ok=True)
        wav_mod.save_wav(path, y, sr)
    name = {"ljspeech": "metadata.csv", "blizzard_nancy": "prompts.data",
            "css10": "transcript.txt"}[layout]
    (root / name).write_text("\n".join(lines), encoding="utf-8")
    return root
