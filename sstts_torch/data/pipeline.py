"""Input pipeline: loading, bucketing, padding, batching.  The port of
`sstts/data/pipeline.py` (41-250).

Every batch is padded to one of a few static (text_len, n_frames) bucket
shapes.  Waveforms ship to the device as PCM16; the train step computes the
features there.  A centered STFT over n samples gives 1 + n // hop frames;
the loss mask ends `ceil((n_fft/2)/hop) + 1` frames early, where the
analysis window starts to cross the end of the valid audio.  `load_audio`
reads a WAV file (`data/wav.py`, numpy), resamples it when
`dataset.resample_on_load` is set, and trims its silence, both in C++
where `native_loader` is built (as the reference's loader does) and with
the numpy codec and `trim_silence` otherwise.  The `Batcher` reads the offline cache
(`data/features_cache.py`) when `dataset.cache_dir` holds one.
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


def trim_silence(
    y: np.ndarray, top_db: float, frame_length: int = 2048, hop_length: int = 512
) -> np.ndarray:
    """Trim leading and trailing frames quieter than `top_db` below the
    loudest frame's RMS; float32.  A copy of `sstts/dsp/reference.py:216-236`
    (RMS in float64 over whole frames: a float32 RMS can move a boundary
    frame)."""
    y64 = np.asarray(y, dtype=np.float64)
    if len(y64) == 0:
        return y64.astype(np.float32)
    if len(y64) < frame_length:
        frames = y64[None]
    else:
        frames = np.lib.stride_tricks.sliding_window_view(y64, frame_length)[::hop_length]
    rms = np.sqrt(np.mean(frames**2, axis=1))
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(np.max(rms), 1e-10))
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return y64[:0].astype(np.float32)
    start = keep[0] * hop_length
    end = min(len(y64), keep[-1] * hop_length + frame_length)
    return y64[start:end].astype(np.float32)


def load_audio(utt: Utterance, cfg: Config) -> np.ndarray:
    """One utterance's waveform (host side): the synthetic corpus's, or a
    WAV file read, resampled to `dataset.sample_rate` where
    `resample_on_load` allows (a `ValueError` on a rate mismatch
    otherwise) and trimmed at `trim_top_db`."""
    ds = cfg.dataset
    if utt.wav_path.startswith("<synthetic"):
        return synthetic.synth_waveform(utt.uid, utt.text, ds)
    from sstts_torch.data import native_loader

    y, sr = native_loader.load_wav(utt.wav_path, sample_rate_hint=ds.sample_rate)
    if sr != ds.sample_rate:
        if not ds.resample_on_load:
            raise ValueError(
                f"{utt.wav_path}: sample rate {sr} != configured "
                f"{ds.sample_rate} (set dataset.resample_on_load to "
                "convert at load time)"
            )
        from sstts_torch.dsp.resample import resample

        y = resample(y, sr, ds.sample_rate)
    return native_loader.trim_silence(y, ds.trim_top_db)


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
    epoch from its seed.  Audio comes from `audio_cache` (default: the
    cache under `dataset.cache_dir`, if one is built) or is loaded on
    first use; a corpus of at most 4096 utterances stays resident.
    Utterances whose text exceeds `max_text_len` or that fit no bucket are
    dropped (`drop_oversize` is the JAX package's argument, which it
    does not read either)."""

    def __init__(
        self,
        utts: Sequence[Utterance],
        cfg: Config,
        drop_oversize: bool = True,
        audio_cache=None,
    ):
        self.cfg = cfg
        if audio_cache is None:
            from sstts_torch.data import features_cache

            audio_cache = features_cache.open_cache(cfg)
        self.audio_cache = audio_cache
        self.shapes = frame_bucket_shapes(cfg)
        self.examples: List[Tuple[Utterance, np.ndarray]] = []
        self._resident: Dict[str, np.ndarray] = {}
        self._len_cache: Dict[str, int] = {}  # uid -> trimmed sample count
        self._cache_all = len(utts) <= 4096
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
        """One utterance's trimmed waveform, from the cache where it holds it."""
        if self._cache_all and u.uid in self._resident:
            return self._resident[u.uid]
        if self.audio_cache is not None and u.uid in self.audio_cache:
            y = self.audio_cache.get(u.uid)
        else:
            y = load_audio(u, self.cfg)
        if self._cache_all:
            self._resident[u.uid] = y
        return y

    def _audio_len(self, u: Utterance) -> int:
        """Trimmed sample count: from the memo, else the cache's index (no
        I/O), else a real load."""
        n = self._len_cache.get(u.uid)
        if n is None:
            if self.audio_cache is not None and u.uid in self.audio_cache:
                n = self.audio_cache.length(u.uid)
            else:
                n = len(self.audio(u))
            self._len_cache[u.uid] = n
        return n

    def batches_per_epoch(self, batch_size: int) -> int:
        """Batch count of one epoch (the same for every shuffle), from the
        lengths alone: a cached corpus is not decoded to count it."""
        per_bucket: Dict[int, int] = {}
        hop = self.cfg.dataset.hop_len
        for u, ids in self.examples:
            bucket = assign_bucket(len(ids), 1 + self._audio_len(u) // hop, self.shapes)
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
            self._len_cache[u.uid] = len(audio)
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
