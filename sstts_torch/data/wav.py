"""Pure-numpy RIFF/WAVE I/O: a copy of `sstts/data/wav.py`, so the port
imports nothing of the JAX package.

A dependency-free codec for PCM16/PCM24/PCM32 and IEEE float32, mono or
multi-channel (downmixed to mono on load).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np


def load_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono samples in [-1, 1], sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            audio_fmt, n_ch, sr, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
            # WAVE_FORMAT_EXTENSIBLE carries the real format in the extension.
            if audio_fmt == 0xFFFE and chunk_size >= 26:
                (audio_fmt,) = struct.unpack_from("<H", body, 24)
            fmt = (audio_fmt, n_ch, sr, bits)
        elif chunk_id == b"data":
            samples = body
        pos += 8 + chunk_size + (chunk_size & 1)
    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, sr, bits = fmt
    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(samples, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(samples, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(samples, dtype=np.uint8)
            raw = raw[: len(raw) - len(raw) % 3].reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (
                np.frombuffer(samples, dtype=np.uint8).astype(np.float32) - 128.0
            ) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(samples, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_fmt}")
    if n_ch > 1:
        x = x[: len(x) - len(x) % n_ch].reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), sr


def save_wav(path: str | Path, samples: np.ndarray, sample_rate: int) -> None:
    """Write float samples (clipped to [-1, 1]) as mono PCM16."""
    samples = np.asarray(samples, dtype=np.float32)
    peak = np.abs(samples).max() if samples.size else 0.0
    if peak > 1.0:
        samples = samples / peak
    pcm = np.round(np.clip(samples, -1.0, 1.0) * 32767.0).astype("<i2")
    body = pcm.tobytes()
    header = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    header += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16
    )
    header += b"data" + struct.pack("<I", len(body))
    Path(path).write_bytes(header + body)
