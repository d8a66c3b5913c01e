"""Griffin-Lim phase reconstruction.

Port of `sstts/dsp/griffin_lim.py` (64-158, 161-256, 259-512).  The
"dft_*" transforms run the real-arithmetic loop over window-support-reduced
DFT GEMMs on the flat spectrum layout (..., n_frames, 2*hp): real lanes
[0, hp), imaginary lanes [hp, 2*hp).  In the bf16 loop ("dft_default") the
Nyquist bin rides in DC's imaginary slot and the loop normalises the (DC,
Nyquist) pair by their joint magnitude; the final synthesis unpacks both
and runs in f32.  "dft_high"/"dft_highest" run the same loop unpacked in
f32.  Every iteration of the JAX package runs:

    "semi"       frames = q @ w_inv; kernel B2 (reprojection + GEMM2 +
                 renorm, `sstts_torch.dsp.gl_fused.fused_reproject_analyze`);
    "split"      frames = q @ w_inv; kernel B1 (`sstts_torch.dsp.reproject`);
                 s = frames @ w_fwd; the renorm in torch;
    "split_xla"  "split" with the reprojection in plain torch ops (no kernel);
    "fused"      kernel B5, the whole iteration (`fused_gl_iteration`).

"auto" is "semi" on every device: on the CPU the JAX package would pick
"split", but the port keeps one default path whose kernel the card runs.
On the card B2 and B5 take both loop dtypes and every geometry with at
most 128 overlapping frames a side, at any window support and bin count
(n_fft 4096 at 44.1 and 48 kHz included; `kernel_config`: their
whole-panel configuration where it fits, the wide one elsewhere), as the
reference's kernels do; beyond that they raise NotImplementedError before
anything is launched ("split", kernel B1, takes up to 256).
"xla"/"default" run the complex
loop over the centred STFT with `torch.fft`, "ct_matmul" with the
four-step matmul FFT (`dsp/fft.py`, full f32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sstts_torch.config import Config
from sstts_torch.dsp import fft as mmfft
from sstts_torch.dsp import ops
from sstts_torch.dsp import stft as stft_mod
from sstts_torch.dsp import gl_tiles
from sstts_torch.dsp.gl_tiles import k_major
from sstts_torch.dsp.gl_fused import (
    fused_gl_iteration,
    fused_reproject_analyze,
    renorm,
)
from sstts_torch.dsp.reproject import band_plan, padded_wss2d, reproject

#: Default Griffin-Lim transform: direct rDFT GEMMs in bf16 (as the JAX
#: package's GL_FFT_IMPL).
GL_FFT_IMPL = "dft_default"
_LOOP_DTYPE = {
    "dft_default": torch.bfloat16,
    "dft_high": torch.float32,
    "dft_highest": torch.float32,
}
ITER_IMPLS = ("auto", "split", "split_xla", "fused", "semi")
#: Transforms of the complex loop over the centred STFT.
_COMPLEX_IMPLS = ("default", "xla", "ct_matmul")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def resolve_iter_impl(iter_impl, momentum: float, fft_impl: str, device) -> str:
    """The iteration a call runs, with the JAX package's validation
    (`ValueError` for an unknown iteration or transform and for "fused"
    with momentum).  `device` does not change the answer: B2 and B5 take
    both loop dtypes on the card (`kernel_config` checks the geometry)."""
    impl = iter_impl or "auto"
    if impl not in ITER_IMPLS:
        raise ValueError(
            f"unknown griffin_lim iter_impl {impl!r}; expected one of "
            "'auto', 'split', 'split_xla', 'fused', 'semi'"
        )
    if momentum > 0.0 and impl == "fused":
        raise ValueError(
            "iter_impl='fused' does not support griffin_lim_momentum > 0 "
            "(the fused kernel folds renorm into the iteration); use "
            "'split', 'semi', or momentum=0"
        )
    if fft_impl not in _LOOP_DTYPE and fft_impl not in _COMPLEX_IMPLS:
        raise ValueError(
            f"unknown griffin_lim fft_impl {fft_impl!r}; valid: 'default', "
            "'xla', 'ct_matmul', 'dft_default', 'dft_high', 'dft_highest'"
        )
    if impl == "auto":
        impl = "semi"
    return impl


def _spectrum_lanes(n_fft: int, half: int, loop_dtype: torch.dtype):
    """(packed, hb): whether the bf16 loop packs the Nyquist bin into DC's
    imaginary slot (an even n_fft), and the bins the flat layout carries."""
    packed = (
        loop_dtype == torch.bfloat16 and n_fft % 2 == 0 and half % 2 == 1
        and half > 2
    )
    return packed, (half - 1 if packed else half)


def kernel_config(iter_impl: str, n_fft: int, hop_length: int, win_length: int,
                  fft_impl: str, device):
    """The tile configuration kernel B2 ("semi") or B5 ("fused") runs on the
    card for this geometry and loop ("panel" or "wide",
    `gl_tiles.config`), or None where neither runs (another iteration or
    transform, or not CUDA).  Raises NotImplementedError, before anything
    is launched, for a geometry beyond both: more than 128 overlapping
    frames a side (`gl_tiles.WIDE_MAX_D`, the reference kernels' bound)."""
    if (torch.device(device).type != "cuda" or iter_impl not in ("semi", "fused")
            or fft_impl not in _LOOP_DTYPE):
        return None
    dtype = _LOOP_DTYPE[fft_impl]
    plan = band_plan(n_fft, hop_length, win_length, 1, 0)
    _, hb = _spectrum_lanes(n_fft, n_fft // 2 + 1, dtype)
    kernel = "gl_fused" if iter_impl == "fused" else "gl_semi"
    return gl_tiles.config(kernel, _round_up(plan["w_len"], 128), _round_up(hb, 128),
                           plan["w_len"], plan["d_max"], iter_impl == "fused", dtype)[0]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation, rounded once to a's dtype: exact f32
    products of the operands on the CPU (as XLA there), the card's GEMM in
    the operands' type (f32 accumulation) on CUDA."""
    if a.device.type == "cpu":
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b


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
    magnitude = magnitude.float()
    n_frames = magnitude.shape[-2]
    if 1 + length // hop_length < n_frames:
        raise ValueError(
            f"length={length} too short for {n_frames} frames at hop={hop_length}"
        )
    impl = resolve_iter_impl(iter_impl, momentum, fft_impl, magnitude.device)
    kernel_config(impl, n_fft, hop_length, win_length, fft_impl, magnitude.device)
    if fft_impl in _COMPLEX_IMPLS:
        return _griffin_lim_complex(
            magnitude, n_fft, hop_length, win_length, n_iters, length, momentum, fft_impl
        )
    return _griffin_lim_real(
        magnitude, n_fft, hop_length, win_length, n_iters, length, momentum,
        _LOOP_DTYPE[fft_impl], impl,
    )


def _griffin_lim_complex(magnitude, n_fft, hop_length, win_length, n_iters,
                         length, momentum, fft_impl):
    """The complex loop over the centred STFT (JAX 136-158), its transforms
    `torch.fft` or the matmul FFT ("ct_matmul", full f32)."""
    n_frames = magnitude.shape[-2]

    def project(angles):
        return stft_mod.istft(
            magnitude * angles, n_fft, hop_length, win_length, length, fft_impl
        )

    angles = torch.ones_like(magnitude, dtype=torch.complex64)
    prev = torch.zeros_like(angles)
    for _ in range(n_iters):
        s = stft_mod.stft(project(angles), n_fft, hop_length, win_length, fft_impl)
        s = s[..., :n_frames, :]
        extrap = s + momentum * (s - prev) if momentum > 0.0 else s
        angles = extrap / torch.clamp(extrap.abs(), min=1e-16)
        prev = s
    return project(angles)


def _griffin_lim_real(magnitude, n_fft, hop_length, win_length, n_iters,
                      length, momentum, loop_dtype, iter_impl):
    """The real-arithmetic loop over direct-DFT GEMMs (JAX 161-256 and
    `_loop_banded`, 259-492)."""
    device = magnitude.device
    n_frames, half = magnitude.shape[-2], magnitude.shape[-1]
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
    packed, hb = _spectrum_lanes(n_fft, half, loop_dtype)
    # The kernels' 128-lane-padded layout on the card, and wherever the
    # iteration needs it (the JAX rule, with the card in place of the TPU);
    # the CPU's "split" runs the window-support widths, as JAX on the CPU.
    if device.type == "cuda" or iter_impl != "split":
        hp, wp = _round_up(hb, 128), _round_up(w_len, 128)
    else:
        hp, wp = hb, w_len

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
    geom = (n_fft, hop_length, win_length, length)
    wss2d = padded_wss2d(plan, wp, device)  # uploaded once
    m32 = float(np.float32(momentum))
    # The K-major copies kernels B2 and B5 read, made once per call.
    on_card = device.type == "cuda"
    w_fwd_t = k_major(w_fwd) if on_card and iter_impl in ("semi", "fused") else None
    w_inv_t = k_major(w_inv) if on_card and iter_impl == "fused" else None
    if iter_impl == "semi":
        if momentum > 0.0:
            prev = torch.zeros_like(q)
            for _ in range(n_iters):
                q, prev = fused_reproject_analyze(
                    _mm(q, w_inv), mag2, w_fwd, *geom, prev=prev,
                    momentum=momentum, wss2d=wss2d, w_fwd_t=w_fwd_t,
                )
        else:
            for _ in range(n_iters):
                q = fused_reproject_analyze(
                    _mm(q, w_inv), mag2, w_fwd, *geom, wss2d=wss2d,
                    w_fwd_t=w_fwd_t,
                )
    elif iter_impl == "fused":
        for _ in range(n_iters):
            q = fused_gl_iteration(q, mag2, w_inv, w_fwd, *geom, wss2d=wss2d,
                                   w_inv_t=w_inv_t, w_fwd_t=w_fwd_t)
    else:
        impl = "xla" if iter_impl == "split_xla" else "auto"
        prev = torch.zeros_like(q)
        for _ in range(n_iters):
            frames = reproject(_mm(q, w_inv), *geom, impl=impl, wss2d=wss2d)
            s = _mm(frames, w_fwd)
            s32 = s.float()
            if momentum > 0.0:
                s32 = s32 + m32 * (s32 - prev.float())
                prev = s
            q = renorm(s32, mag2, hp, loop_dtype)

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
