"""Input pipeline: bucketing, padding, batching.  The port of
`sstts/data/pipeline.py` (41-250) over the synthetic corpus.

Every batch is padded to one of a few static (text_len, n_frames) bucket
shapes.  Waveforms ship to the device as PCM16; the train step computes the
features there.  A centered STFT over n samples gives 1 + n // hop frames;
the loss mask ends `ceil((n_fft/2)/hop) + 1` frames early, where the
analysis window starts to cross the end of the valid audio.  Loading audio
files (`load_audio` of an LJSpeech corpus, the features cache) is not
ported yet (ROADMAP A.6).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from sstts_torch.config import Config
from sstts_torch.data import synthetic
from sstts_torch.data import text as text_mod
from sstts_torch.data.ljspeech import Utterance

Batch = Dict[str, np.ndarray]
# Batch fields:
#   char_ids:    (B, L)  int32, 0-padded, EOS-terminated
#   text_len:    (B,)    int32
#   samples:     (B, S)  int16 zero-padded waveform (PCM16)
#   n_frames:    (B,)    int32  total valid STFT frames
#   loss_frames: (B,)    int32  frames included in the loss (see module doc)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def load_audio(utt: Utterance, cfg: Config) -> np.ndarray:
    """One utterance's waveform; the synthetic corpus only."""
    if not utt.wav_path.startswith("<synthetic"):
        raise NotImplementedError(
            f"{utt.wav_path}: loading audio files is not ported yet "
            "(ROADMAP A.6); use dataset='synthetic'"
        )
    return synthetic.synth_waveform(utt.uid, utt.text, cfg.dataset)


def frame_bucket_shapes(cfg: Config) -> List[Tuple[int, int]]:
    """Static (text_len, n_frames) bucket shapes; frames rounded up to r."""
    r = cfg.arch.reduction_factor
    return [
        (lt, _cdiv(fb, r) * r)
        for lt, fb in zip(cfg.training.text_buckets, cfg.training.frame_buckets)
    ]


def assign_bucket(text_len: int, n_frames: int, shapes: Sequence[Tuple[int, int]]) -> int:
    """Smallest bucket that fits, or -1 if none does."""
    for i, (lt, fr) in enumerate(shapes):
        if text_len <= lt and n_frames <= fr:
            return i
    return -1


def make_batch(
    items: Sequence[Tuple[np.ndarray, np.ndarray]],
    text_len: int,
    n_frames: int,
    cfg: Config,
) -> Batch:
    """Pad (ids, audio) pairs to the static bucket shape."""
    ds = cfg.dataset
    hop, n_fft = ds.hop_len, ds.n_fft
    n_samples = (n_frames - 1) * hop  # -> exactly n_frames centered frames
    bsz = len(items)
    char_ids = np.zeros((bsz, text_len), dtype=np.int32)
    samples = np.zeros((bsz, n_samples), dtype=np.int16)
    tlen = np.zeros((bsz,), dtype=np.int32)
    frames = np.zeros((bsz,), dtype=np.int32)
    loss_frames = np.zeros((bsz,), dtype=np.int32)
    guard = _cdiv(n_fft // 2, hop) + 1
    for b, (ids, audio) in enumerate(items):
        audio = audio[:n_samples]
        char_ids[b, : len(ids)] = ids
        tlen[b] = len(ids)
        samples[b, : len(audio)] = np.round(np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
        nf = min(n_frames, 1 + len(audio) // hop)
        frames[b] = nf
        loss_frames[b] = max(1, nf - guard)
    return {
        "char_ids": char_ids,
        "text_len": tlen,
        "samples": samples,
        "n_frames": frames,
        "loss_frames": loss_frames,
    }


class Batcher:
    """Bucketed batch iterator over a list of utterances, shuffled per
    epoch from its seed; the synthetic corpus stays resident."""

    def __init__(self, utts: Sequence[Utterance], cfg: Config):
        self.cfg = cfg
        self.shapes = frame_bucket_shapes(cfg)
        self.examples: List[Tuple[Utterance, np.ndarray]] = []
        self._audio: Dict[str, np.ndarray] = {}
        self.skipped = 0
        for u in utts:
            ids = text_mod.encode(
                u.text,
                extra_chars=cfg.dataset.extra_chars,
                expand_numbers=cfg.dataset.expand_numbers,
            )
            if len(ids) > cfg.dataset.max_text_len:
                self.skipped += 1
                continue
            self.examples.append((u, ids))

    def audio(self, u: Utterance) -> np.ndarray:
        if u.uid not in self._audio:
            self._audio[u.uid] = load_audio(u, self.cfg)
        return self._audio[u.uid]

    def batches_per_epoch(self, batch_size: int) -> int:
        """Batch count of one epoch (the same for every shuffle)."""
        per_bucket: Dict[int, int] = {}
        hop = self.cfg.dataset.hop_len
        for u, ids in self.examples:
            bucket = assign_bucket(len(ids), 1 + len(self.audio(u)) // hop, self.shapes)
            if bucket >= 0:
                per_bucket[bucket] = per_bucket.get(bucket, 0) + 1
        return sum(-(-n // batch_size) for n in per_bucket.values())

    def epoch(self, seed: int, batch_size: int) -> Iterator[Tuple[int, Batch]]:
        """Yield (bucket_index, batch) pairs covering the corpus once."""
        rng = np.random.default_rng(seed)
        pools: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
        hop = self.cfg.dataset.hop_len
        for idx in rng.permutation(len(self.examples)):
            u, ids = self.examples[idx]
            audio = self.audio(u)
            bucket = assign_bucket(len(ids), 1 + len(audio) // hop, self.shapes)
            if bucket < 0:
                continue
            pools.setdefault(bucket, []).append((ids, audio))
            if len(pools[bucket]) == batch_size:
                lt, fr = self.shapes[bucket]
                yield bucket, make_batch(pools.pop(bucket), lt, fr, self.cfg)
        # Remainders repeat entries to fill the static batch; the fill rows
        # are masked out of the loss (loss_frames = 0), so repeated
        # utterances get no double weight at the epoch tail.
        for bucket, items in pools.items():
            n_real = len(items)
            while len(items) < batch_size:
                items.append(items[len(items) % n_real])
            lt, fr = self.shapes[bucket]
            batch = make_batch(items[:batch_size], lt, fr, self.cfg)
            batch["loss_frames"][n_real:] = 0
            yield bucket, batch
