"""Window, framing, STFT, inverse window-sum envelope and overlap-add.

Port of `sstts/dsp/stft.py` (34-150, the centered `stft` and `istft` at
153-189 and `num_frames`) and of the host helpers `hann_window`/`pad_center`
(`sstts/dsp/reference.py:24-34`).  `fft_impl` picks the transform as the
reference's `_rfft`/`_irfft` do: "default" and "xla" are `torch.fft` (XLA's
FFT in the JAX package, outside any kernel of its own), "ct_matmul" the
four-step matmul FFT and "dft_*" the direct DFT GEMMs of `dsp/fft.py`; a
size `fft.supported` refuses takes `torch.fft` under any of them.  The
numpy helpers are copies, so the port never imports the JAX package; they
return host numpy (they are cached, and a cached tensor would pin one
device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sstts_torch.dsp import fft as mmfft

FFT_IMPLS = ("default", "xla", "ct_matmul", *mmfft.DFT_IMPLS)


def _transform(impl: str, n: int) -> str:
    """"torch", "ct_matmul" or a DFT rung for `impl` at size n."""
    if impl not in FFT_IMPLS:
        raise ValueError(f"unknown fft impl: {impl}")
    if impl in ("default", "xla") or not mmfft.supported(n):
        return "torch"
    return impl


def _rfft(x: torch.Tensor, n: int, impl: str = "default") -> torch.Tensor:
    kind = _transform(impl, n)
    if kind == "torch":
        return torch.fft.rfft(x, n=n)
    if kind == "ct_matmul":
        return mmfft.rfft(x, n)
    return mmfft.rdft(x, n, kind)


def _irfft(spec: torch.Tensor, n: int, impl: str = "default") -> torch.Tensor:
    kind = _transform(impl, n)
    if kind == "torch":
        return torch.fft.irfft(spec, n=n)
    if kind == "ct_matmul":
        return mmfft.irfft(spec, n)
    return mmfft.irdft(spec, n, kind)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic ("fftbins") Hann window, as used by librosa/scipy for STFT."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to `size` (librosa.util.pad_center)."""
    lpad = (size - len(window)) // 2
    rpad = size - len(window) - lpad
    return np.pad(window, (lpad, rpad))


@functools.lru_cache(maxsize=None)
def window(n_fft: int, win_length: int) -> np.ndarray:
    """Periodic Hann window center-padded to n_fft (float32)."""
    return pad_center(hann_window(win_length), n_fft).astype(np.float32)


@functools.lru_cache(maxsize=None)
def window_sum_sq(
    n_fft: int, hop_length: int, win_length: int, n_frames: int
) -> np.ndarray:
    """Inverse of the overlap-added squared-window envelope (float32), 1.0
    where the envelope vanishes."""
    w2 = window(n_fft, win_length).astype(np.float64) ** 2
    total = (n_frames - 1) * hop_length + n_fft
    wss = np.zeros(total, dtype=np.float64)
    for i in range(n_frames):
        wss[i * hop_length : i * hop_length + n_fft] += w2
    inv = np.where(wss > 1e-10, 1.0 / np.maximum(wss, 1e-10), 1.0)
    return inv.astype(np.float32)


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(..., n_frames, n) -> (..., (n_frames - 1) * hop + n) by overlap-add."""
    *batch, n_frames, n = frames.shape
    total = (n_frames - 1) * hop_length + n
    cols = frames.reshape(-1, n_frames, n).transpose(1, 2)  # (N, n, n_frames)
    y = F.fold(
        cols, output_size=(1, total), kernel_size=(1, n),
        stride=(1, hop_length),
    )
    return y.reshape(*batch, total)


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(..., n_samples) already-padded signal -> (..., n_frames, n_fft):
    frame i covers samples [i*hop, i*hop + n_fft), as many as fit."""
    return y.unfold(-1, n_fft, hop_length)


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         fft_impl: str = "default") -> torch.Tensor:
    """Centered batched STFT with librosa semantics: reflect padding by
    n_fft//2 on both sides, periodic Hann of win_length center-padded to
    n_fft.  (..., n_samples) -> complex (..., n_frames, n_fft//2 + 1)."""
    lead = y.shape[:-1]
    pad = n_fft // 2
    y = F.pad(y.reshape(-1, 1, y.shape[-1]), (pad, pad), mode="reflect")
    frames = frame_signal(y.reshape(*lead, -1), n_fft, hop_length)
    win = torch.as_tensor(window(n_fft, win_length), device=y.device)
    return _rfft(frames * win, n_fft, fft_impl)


def istft(
    spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int, length: int,
    fft_impl: str = "default",
) -> torch.Tensor:
    """Inverse of `stft`: complex (..., n_frames, n_fft//2 + 1) ->
    (..., length) samples by windowed overlap-add, window-sum
    normalisation and the centre trim."""
    n_frames = spec.shape[-2]
    win = torch.as_tensor(window(n_fft, win_length), device=spec.device)
    y = overlap_add(_irfft(spec, n_fft, fft_impl) * win, hop_length)
    inv = window_sum_sq(n_fft, hop_length, win_length, n_frames)
    y = y * torch.as_tensor(inv, device=spec.device)
    start = n_fft // 2
    return y[..., start : start + length]


def num_frames(n_samples: int, hop_length: int) -> int:
    """Frame count of a centered STFT over n_samples."""
    return 1 + n_samples // hop_length
