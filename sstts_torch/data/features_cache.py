"""The offline corpus cache: the port of `sstts/data/features_cache.py`.

The training cache stores what the host owes the device: each utterance's
decoded, silence-trimmed waveform as PCM16 (the wire format).
`precompute_features` adds the normalized mel and linear features, made on
the device by the `wav_to_features` the train step runs, for analysis and
tools.  The layout and the fingerprint are the JAX package's, so a cache
built by either package opens in the other:

    <cache_dir>/index.json   fingerprint + {uid: {"off": o, "len": n}} offsets
    <cache_dir>/audio.bin    concatenated int16 PCM (memory-mapped on open)
    <cache_dir>/mel.bin      optional, float16 (sum_frames, n_mels)
    <cache_dir>/linear.bin   optional, float16 (sum_frames, n_fft//2+1)

PCM16 is lossless for training: `pipeline.make_batch` quantizes every
waveform to PCM16 anyway, and f32 -> i16 -> f32 -> i16 round-trips
exactly, so batches from the cache equal batches from the WAV files byte
for byte.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sstts_torch.config import Config
from sstts_torch.data.ljspeech import Utterance
from sstts_torch.dsp.ops import wav_to_features
from sstts_torch.synthesize import exact_f32, resolve_device

_INDEX = "index.json"
_AUDIO = "audio.bin"
_MEL = "mel.bin"
_LINEAR = "linear.bin"


def _fingerprint(cfg: Config) -> Dict[str, object]:
    """The config facts that invalidate cached audio/features."""
    ds = cfg.dataset
    return {
        "dataset": ds.dataset,
        "sample_rate": ds.sample_rate,
        "trim_top_db": ds.trim_top_db,
        "n_fft": ds.n_fft,
        "win_len_ms": ds.win_len_ms,
        "win_hop_ms": ds.win_hop_ms,
        "n_mels": ds.n_mels,
        "mel_fmin": ds.mel_fmin,
        "mel_fmax": ds.mel_fmax,
        "preemphasis": ds.preemphasis,
        "ref_level_db": ds.ref_level_db,
        "min_level_db": ds.min_level_db,
    }


def _quantize(y: np.ndarray) -> np.ndarray:
    """float waveform -> PCM16, exactly as `pipeline.make_batch` does."""
    return np.round(np.clip(y, -1.0, 1.0) * 32767.0).astype(np.int16)


def build_audio_cache(
    utts: Sequence[Utterance],
    cfg: Config,
    cache_dir: str | Path,
    progress_every: int = 1000,
) -> "AudioCache":
    """Decode and trim every utterance once; write the consolidated store."""
    from sstts_torch.data import pipeline as pipeline_mod

    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    index: Dict[str, Dict[str, int]] = {}
    off = 0
    with open(cache_dir / _AUDIO, "wb") as f:
        for i, u in enumerate(utts):
            pcm = _quantize(pipeline_mod.load_audio(u, cfg))
            f.write(pcm.tobytes())
            index[u.uid] = {"off": off, "len": int(pcm.size)}
            off += int(pcm.size)
            if progress_every and (i + 1) % progress_every == 0:
                print(f"[cache] audio {i + 1}/{len(utts)}", flush=True)
    meta = {"fingerprint": _fingerprint(cfg), "audio": index}
    (cache_dir / _INDEX).write_text(json.dumps(meta))
    return AudioCache(cache_dir, cfg)


class AudioCache:
    """Memory-mapped read side of the consolidated audio store."""

    def __init__(self, cache_dir: str | Path, cfg: Config):
        self.dir = Path(cache_dir)
        meta = json.loads((self.dir / _INDEX).read_text())
        if meta["fingerprint"] != _fingerprint(cfg):
            raise ValueError(
                f"feature cache at {self.dir} was built with different "
                f"dataset hyperparameters; rebuild it "
                f"(cached={meta['fingerprint']})"
            )
        self._index: Dict[str, Dict[str, int]] = meta["audio"]
        self._pcm = np.memmap(self.dir / _AUDIO, dtype=np.int16, mode="r")
        self._features: Optional[Dict[str, Dict[str, int]]] = meta.get("features")
        self._mel = self._linear = None

    @staticmethod
    def exists(cache_dir: str | Path) -> bool:
        return (Path(cache_dir) / _INDEX).exists()

    def __contains__(self, uid: str) -> bool:
        return uid in self._index

    def __len__(self) -> int:
        return len(self._index)

    def get(self, uid: str) -> np.ndarray:
        """Trimmed waveform as float32 in [-1, 1] (dequantized PCM16)."""
        return self.get_pcm(uid).astype(np.float32) / 32767.0

    def get_pcm(self, uid: str) -> np.ndarray:
        e = self._index[uid]
        return np.asarray(self._pcm[e["off"] : e["off"] + e["len"]])

    def length(self, uid: str) -> int:
        """Trimmed sample count, from the index (no I/O)."""
        return int(self._index[uid]["len"])

    def has_features(self) -> bool:
        return self._features is not None and (self.dir / _MEL).exists()

    def get_features(self, uid: str, cfg: Config) -> Tuple[np.ndarray, np.ndarray]:
        """(linear, mel) normalized spectrograms, float16, (n_frames, bins)."""
        if not self.has_features():
            raise KeyError("cache has no precomputed features; run precompute")
        if self._mel is None:
            self._mel = np.memmap(self.dir / _MEL, dtype=np.float16, mode="r").reshape(
                -1, cfg.dataset.n_mels
            )
            self._linear = np.memmap(
                self.dir / _LINEAR, dtype=np.float16, mode="r"
            ).reshape(-1, cfg.dataset.n_linear)
        e = self._features[uid]
        sl = slice(e["off"], e["off"] + e["len"])
        return np.asarray(self._linear[sl]), np.asarray(self._mel[sl])


def precompute_features(
    cache: AudioCache,
    utts: Sequence[Utterance],
    cfg: Config,
    batch_frames: int = 4096,
    progress_every: int = 1000,
    device=None,
) -> None:
    """Featurize the cached audio on `device` (None: the card) into
    mel.bin / linear.bin.  Each utterance is padded to one static segment
    of `batch_frames` frames, as the JAX package does, so every call runs
    one shape of FFT; an utterance's frames beyond `batch_frames` are not
    stored."""
    dev = resolve_device(device)
    ds = cfg.dataset
    hop = ds.hop_len
    seg_samples = (batch_frames - 1) * hop
    index: Dict[str, Dict[str, int]] = {}
    off = 0
    with (
        open(cache.dir / _MEL, "wb") as fm,
        open(cache.dir / _LINEAR, "wb") as fl,
        torch.no_grad(),
        exact_f32(dev),
    ):
        for i, u in enumerate(utts):
            pcm = cache.get_pcm(u.uid)
            n_frames = min(1 + len(pcm) // hop, batch_frames)
            buf = np.zeros((seg_samples,), dtype=np.int16)
            buf[: min(len(pcm), seg_samples)] = pcm[:seg_samples]
            y = torch.from_numpy(buf).to(dev).float() / 32767.0
            linear, mel = wav_to_features(y, ds)
            fm.write(mel[:n_frames].half().cpu().numpy().tobytes())
            fl.write(linear[:n_frames].half().cpu().numpy().tobytes())
            index[u.uid] = {"off": off, "len": int(n_frames)}
            off += int(n_frames)
            if progress_every and (i + 1) % progress_every == 0:
                print(f"[cache] features {i + 1}/{len(utts)}", flush=True)
    meta = json.loads((cache.dir / _INDEX).read_text())
    meta["features"] = index
    (cache.dir / _INDEX).write_text(json.dumps(meta))
    cache._features = index
    cache._mel = cache._linear = None


def open_cache(cfg: Config) -> Optional[AudioCache]:
    """The cache under `dataset.cache_dir`, if that is set and built."""
    d = cfg.dataset.cache_dir
    if d and AudioCache.exists(d):
        return AudioCache(d, cfg)
    return None
