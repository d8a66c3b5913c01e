"""Griffin-Lim phase reconstruction on the banded, packed layout.

Port of `sstts/dsp/griffin_lim.py` (64-134, 161-256, 259-512): the
real-arithmetic loop over window-support-reduced DFT GEMMs, in the "semi"
iteration that the JAX package picks on its accelerator.  Each iteration is

    frames = q @ w_inv                     (torch.matmul in the loop dtype)
    q      = fused_reproject_analyze(...)  (kernel B2, sstts_torch.dsp.gl_fused)

on the flat spectrum layout (..., n_frames, 2*hp): real lanes [0, hp),
imaginary lanes [hp, 2*hp), hp the bin count rounded up to 128 lanes.  In
the bf16 loop ("dft_default") the Nyquist bin rides in DC's imaginary slot
and the loop normalises the (DC, Nyquist) pair by their joint magnitude; the
final synthesis unpacks both and runs in f32.  "dft_high"/"dft_highest"
run the same loop unpacked in f32 (CPU only in this port: the CUDA kernel is
bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sstts_torch.config import Config
from sstts_torch.dsp import fft as mmfft
from sstts_torch.dsp import ops
from sstts_torch.dsp import stft as stft_mod
from sstts_torch.dsp.gl_fused import fused_reproject_analyze
from sstts_torch.dsp.reproject import band_plan, padded_wss2d

#: Default Griffin-Lim transform: direct rDFT GEMMs in bf16 (as the JAX
#: package's GL_FFT_IMPL).
GL_FFT_IMPL = "dft_default"
_LOOP_DTYPE = {
    "dft_default": torch.bfloat16,
    "dft_high": torch.float32,
    "dft_highest": torch.float32,
}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def griffin_lim(
    magnitude: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    n_iters: int,
    length: int,
    momentum: float = 0.0,
    fft_impl: str = GL_FFT_IMPL,
    iter_impl: str | None = None,
) -> torch.Tensor:
    """(..., n_frames, bins) magnitude -> (..., length) waveform (f32).

    Deterministic zero-phase init; momentum > 0 is the fast Griffin-Lim
    update (Perraudin et al. 2013).
    """
    if (iter_impl or "auto") not in ("auto", "semi"):
        raise NotImplementedError(
            f"griffin_lim iter_impl={iter_impl!r}: this port runs the semi "
            "iteration only ('auto'/'semi'); 'split', 'split_xla' and 'fused' "
            "are ROADMAP items B.1 and B.5"
        )
    if fft_impl not in _LOOP_DTYPE:
        raise NotImplementedError(
            f"griffin_lim fft_impl={fft_impl!r}: this port runs the direct-DFT "
            "loop only ('dft_default', 'dft_high', 'dft_highest')"
        )
    loop_dtype = _LOOP_DTYPE[fft_impl]
    magnitude = magnitude.float()
    device = magnitude.device
    n_frames, half = magnitude.shape[-2], magnitude.shape[-1]
    if 1 + length // hop_length < n_frames:
        raise ValueError(
            f"length={length} too short for {n_frames} frames at hop={hop_length}"
        )

    window_np = stft_mod.window(n_fft, win_length)
    inv_wss_full = stft_mod.window_sum_sq(n_fft, hop_length, win_length, n_frames)
    lo, w_len, cos_w, nsin_w, inv_re_w, inv_im_w = mmfft.rdft_matrices_windowed(
        n_fft, window_np, device
    )
    start = n_fft // 2 - lo
    inv_wss = torch.as_tensor(
        inv_wss_full[n_fft // 2 : n_fft // 2 + length], device=device
    )

    def synth(sr, si):
        """(re, im) spectra -> time signal (one reduced iSTFT, f32)."""
        frames = sr @ inv_re_w + si @ inv_im_w
        y = stft_mod.overlap_add(frames, hop_length)
        short = start + length - y.shape[-1]
        if short > 0:  # tail beyond the last frame's window support
            y = F.pad(y, (0, short))
        return y[..., start : start + length] * inv_wss

    mag_d = magnitude.to(loop_dtype)
    # Nyquist packing needs an even n_fft (a purely real top bin).
    packed = (
        loop_dtype == torch.bfloat16 and n_fft % 2 == 0 and half % 2 == 1
        and half > 2
    )
    hb = half - 1 if packed else half
    hp = _round_up(hb, 128)
    wp = _round_up(w_len, 128)

    def rowpad(m):  # (rows <= hp, w_len) -> (hp, wp)
        return F.pad(m, (0, wp - w_len, 0, hp - m.shape[0]))

    def colpad(m):  # (w_len, cols <= hp) -> (wp, hp)
        return F.pad(m, (0, hp - m.shape[1], 0, wp - w_len))

    lane_pad = (0, hp - hb)
    if packed:
        w_inv = torch.cat(
            [
                rowpad(inv_re_w[:hb]),
                rowpad(torch.cat([inv_re_w[hb:], inv_im_w[1:hb]], dim=0)),
            ],
            dim=0,
        )
        w_fwd = torch.cat(
            [
                colpad(cos_w[:, :hb]),
                colpad(torch.cat([cos_w[:, hb:], nsin_w[:, 1:hb]], dim=1)),
            ],
            dim=1,
        )
        mag_r = F.pad(mag_d[..., :hb], lane_pad)
        mag_i = F.pad(torch.cat([mag_d[..., hb:], mag_d[..., 1:hb]], dim=-1), lane_pad)
        qi0 = F.pad(mag_i[..., :1], (0, hp - 1))
    else:
        w_inv = torch.cat([rowpad(inv_re_w), rowpad(inv_im_w)], dim=0)
        w_fwd = torch.cat([colpad(cos_w), colpad(nsin_w)], dim=1)
        mag_r = F.pad(mag_d, lane_pad)
        mag_i = mag_r
        qi0 = torch.zeros_like(mag_r)
    w_inv = w_inv.to(loop_dtype)
    w_fwd = w_fwd.to(loop_dtype)
    mag2 = torch.cat([mag_r, mag_i], dim=-1).to(loop_dtype)
    q = torch.cat([mag_r, qi0], dim=-1).to(loop_dtype)

    plan = band_plan(n_fft, hop_length, win_length, n_frames, length)
    args = (w_fwd, n_fft, hop_length, win_length, length)
    kw = {"wss2d": padded_wss2d(plan, wp, device)}  # uploaded once
    if momentum > 0.0:
        prev = torch.zeros_like(q)
        for _ in range(n_iters):
            q, prev = fused_reproject_analyze(
                q @ w_inv, mag2, *args, prev=prev, momentum=momentum, **kw
            )
    else:
        for _ in range(n_iters):
            q = fused_reproject_analyze(q @ w_inv, mag2, *args, **kw)

    # Final synthesis in f32: recover the unit phase from the scaled
    # spectrum and apply the exact f32 magnitude; the packed layout unpacks
    # DC/Nyquist and projects each exactly.
    if packed:
        qr = q[..., :hp].float()
        qi = q[..., hp:].float()
        zero1 = torch.zeros_like(qr[..., :1])
        sr = torch.cat([qr[..., :hb], qi[..., :1]], dim=-1)
        si = torch.cat([zero1, qi[..., 1:hb], zero1], dim=-1)
    else:
        sr = q[..., :half].float()
        si = q[..., hp : hp + half].float()
    inv = torch.rsqrt(sr * sr + si * si + 1e-24)
    return synth(magnitude * (sr * inv), magnitude * (si * inv))


def spectrogram_to_wav(
    linear_norm: torch.Tensor, cfg: Config, length: int
) -> torch.Tensor:
    """Normalized linear spectrogram -> waveform: de-normalise dB, raise the
    magnitude to the Griffin-Lim power, reconstruct phase, de-emphasise."""
    ds, inf = cfg.dataset, cfg.inference
    db = ops.inv_normalize_decibel(linear_norm, ds.ref_level_db, ds.min_level_db)
    mag = ops.decibel_to_magnitude(db) ** inf.griffin_lim_power
    y = griffin_lim(
        mag, ds.n_fft, ds.hop_len, ds.win_len, inf.griffin_lim_iters, length,
        momentum=inf.griffin_lim_momentum,
        fft_impl=inf.griffin_lim_fft_impl or GL_FFT_IMPL,
        iter_impl=inf.griffin_lim_iter_impl,
    )
    return ops.deemphasis(y, ds.preemphasis)

