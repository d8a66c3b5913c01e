"""ctypes bindings of the native C++ WAV decoder, silence trimmer and ADPCM
row decoder: the port of `sstts/data/native_loader.py` (24-176).

`sstts_torch/csrc/host/wavio.cpp` (the port's copy of the JAX package's
source) is built with `g++` on first use into `sstts_torch/_build/`
(git-ignored), named by a hash of the source and the flags, and loaded with
`ctypes`.  Where no toolchain builds it, every function takes the numpy
codec instead (`sstts_torch.data.wav`, `pipeline.trim_silence`,
`dsp.ops`'s row decoders), as the reference's does: the numpy versions are
also the oracle the tests hold it to.  ctypes releases the interpreter lock
around each call, so a decode overlaps other threads' work.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host" / "wavio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsstts_torch_wavio-{digest[:12]}.so"


@functools.lru_cache(maxsize=None)
def _library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first where missing; None where `g++`
    cannot build it."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)  # atomic: concurrent builds race harmlessly
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.sstts_decode_wav.restype = ctypes.c_int64
    lib.sstts_decode_wav.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int64, _i32p]
    lib.sstts_trim_silence.restype = None
    lib.sstts_trim_silence.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_float, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p,
    ]
    lib.sstts_decode_batch.restype = None
    lib.sstts_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, _f32p, ctypes.c_int64,
        _i64p, _i32p, ctypes.c_int32,
    ]
    lib.sstts_adpcm_decode.restype = None
    lib.sstts_adpcm_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int64, ctypes.c_int32,
        _f32p, ctypes.c_int32,
    ]
    return lib


def available() -> bool:
    """Whether the native library is built and loaded (building it now)."""
    return _library() is not None


def load_wav(path: str | Path, max_seconds: float = 60.0,
             sample_rate_hint: int = 48000) -> Tuple[np.ndarray, int]:
    """Decode a WAV file -> (float32 mono, sample_rate); the numpy codec
    where the library is not built."""
    lib = _library()
    if lib is None:
        from sstts_torch.data import wav as wav_mod

        return wav_mod.load_wav(path)
    max_len = int(max_seconds * sample_rate_hint)
    buf = np.empty(max_len, dtype=np.float32)
    sr = ctypes.c_int32(0)
    n = lib.sstts_decode_wav(str(path).encode(), buf.ctypes.data_as(_f32p), max_len,
                             ctypes.byref(sr))
    if n == -5:  # the buffer is too small: retry with a larger bound
        return load_wav(path, max_seconds * 4, sample_rate_hint)
    if n < 0:
        raise ValueError(f"{path}: native WAV decode failed (code {n})")
    return buf[:n].copy(), int(sr.value)


def trim_silence(y: np.ndarray, top_db: float, frame_length: int = 2048,
                 hop_length: int = 512) -> np.ndarray:
    """`pipeline.trim_silence` in C++ (RMS in float64 over whole frames)."""
    lib = _library()
    if lib is None:
        from sstts_torch.data.pipeline import trim_silence as trim_np

        return trim_np(y, top_db, frame_length, hop_length)
    y = np.ascontiguousarray(y, dtype=np.float32)
    start, end = ctypes.c_int64(0), ctypes.c_int64(0)
    lib.sstts_trim_silence(y.ctypes.data_as(_f32p), len(y), ctypes.c_float(top_db),
                           frame_length, hop_length, ctypes.byref(start), ctypes.byref(end))
    return y[start.value : end.value]


def adpcm_decode_rows(rows: np.ndarray, bits: int) -> Optional[np.ndarray]:
    """Native decode of an ADPCM wire matrix -> (B, nb * 256) float32, the
    (B, W) uint8 rows of `dsp.ops.adpcm{4,3,2}_encode_wire` (`bits` 4, 3 or
    2); None where the library is not built (the caller's numpy decoder
    then runs)."""
    lib = _library()
    if lib is None:
        return None
    if bits not in (2, 3, 4):
        raise ValueError(f"adpcm_decode_rows: bits must be 2, 3 or 4, got {bits}")
    rows = np.ascontiguousarray(np.atleast_2d(np.asarray(rows, np.uint8)))
    nb = rows.shape[1] // (256 * bits // 8 + 4)
    out = np.empty((rows.shape[0], nb * 256), np.float32)
    lib.sstts_adpcm_decode(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rows.shape[0], rows.shape[1],
        bits, out.ctypes.data_as(_f32p), min(rows.shape[0], os.cpu_count() or 1),
    )
    return out


def decode_batch(paths: List[str], max_len: int,
                 n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode files in parallel -> (audio (n, max_len) f32 zero-padded,
    lengths (n,), sample rates (n,)); lengths[i] < 0 marks a file that
    failed to decode (the caller decides what to do)."""
    out = np.zeros((len(paths), max_len), np.float32)
    lengths = np.zeros(len(paths), np.int64)
    srs = np.zeros(len(paths), np.int32)
    lib = _library()
    if lib is None:
        from sstts_torch.data import wav as wav_mod

        for i, p in enumerate(paths):
            try:
                y, sr = wav_mod.load_wav(p)
            except (ValueError, OSError):
                lengths[i] = -1
                continue
            y = y[:max_len]
            out[i, : len(y)] = y
            lengths[i], srs[i] = len(y), sr
        return out, lengths, srs
    arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
    if n_threads <= 0:
        n_threads = min(len(paths), os.cpu_count() or 4)
    lib.sstts_decode_batch(arr, len(paths), out.ctypes.data_as(_f32p), max_len,
                           lengths.ctypes.data_as(_i64p), srs.ctypes.data_as(_i32p), n_threads)
    return out, lengths, srs
