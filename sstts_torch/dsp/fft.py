"""Matmul transforms: the port of `sstts/dsp/fft.py` (50-352).

* The four-step Cooley-Tukey real FFT (`rfft`, `irfft`;
  `fft_impl="ct_matmul"`).  A real FFT of even size N packs even and odd
  samples into one complex signal of N/2, whose complex FFT factors as
  N/2 = N1 * N2 (`_best_split`, N1 and N2 near sqrt(N/2)): a DFT of N1
  down the columns, twiddles, a DFT of N2 across the rows, a transpose,
  every stage one flat GEMM of real and imaginary parts; O(N) unpacking
  turns the result into the N/2 + 1 bins.  The GEMMs run in full f32 (the
  reference's HIGHEST), TF32 off on the card whatever the caller set.  A
  size that does not factor so (odd N, or N/2 prime) takes `torch.fft`,
  as the reference takes XLA's FFT.
* The direct real DFT as GEMMs against [cos | -sin] (`rdft`, `irdft`,
  `rdft_ri`, `irdft_ri`) at the reference's precision rungs (`matmul_at`):
  "dft_highest" f32; "dft_high" three TF32 products in place of one f32
  product on the card (each operand split into a part exact in TF32 and
  the rest), XLA's HIGH; "dft_default" one pass of bf16 operands with f32
  accumulation, XLA's DEFAULT.  On the CPU every rung runs in f32, as
  XLA:CPU runs them.
* The window-folded, support-reduced DFT matrices of the Griffin-Lim loop
  and the features (`rdft_matrices_windowed`).

Every phase is computed as `(t * k) mod n` in integers and only then scaled
to radians in f32, so large `t * k` products lose no precision.  Host
constants are cached as numpy (a cached tensor would pin one device).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

DFT_IMPLS = ("dft_default", "dft_high", "dft_highest")


@contextlib.contextmanager
def _tf32(device: torch.device, allow: bool):
    """cuBLAS's TF32 switch set to `allow` for the block (the card only)."""
    if device.type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = allow
    try:
        yield
    finally:
        matmul.allow_tf32 = saved


def tf32_split(x: torch.Tensor):
    """(hi, lo) with hi + lo == x exactly and hi exact in TF32 (its low 13
    mantissa bits zero, rounded to nearest)."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def matmul_at(a: torch.Tensor, b: torch.Tensor, impl: str) -> torch.Tensor:
    """a (M, K) @ b (K, N), f32 out, at a DFT precision rung (module
    docstring); f32 on the CPU."""
    if impl not in DFT_IMPLS:
        raise ValueError(f"unknown DFT precision {impl!r}; valid: {DFT_IMPLS}")
    if a.device.type != "cuda":
        return a.float() @ b.float()
    if impl == "dft_default":
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16), out_dtype=torch.float32)
    a, b = a.float(), b.float()
    with _tf32(a.device, impl == "dft_high"):
        if impl == "dft_high":
            (a_hi, a_lo), (b_hi, b_lo) = tf32_split(a), tf32_split(b)
            return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)
        return a @ b


# ------------------------------------------------- four-step Cooley-Tukey --


def _best_split(n: int) -> Optional[Tuple[int, int]]:
    """n = a * b with a, b as close to sqrt(n) as possible (a <= b)."""
    for a in range(int(math.isqrt(n)), 1, -1):
        if n % a == 0:
            return a, n // a
    return None


@functools.lru_cache(maxsize=None)
def _cfft_consts(n: int):
    """(n1, n2, DFT_N1 re/im, twiddle re/im, DFT_N2 re/im) as f32 numpy, or
    None where n does not factor."""
    split = _best_split(n)
    if split is None:
        return None
    n1, n2 = split
    k1 = np.arange(n1)
    d1 = np.exp(-2j * np.pi * np.outer(k1, k1) / n1)  # (k1, n1)
    tw = np.exp(-2j * np.pi * np.outer(np.arange(n1), np.arange(n2)) / n)  # (k1, n2)
    j2 = np.arange(n2)
    d2 = np.exp(-2j * np.pi * np.outer(j2, j2) / n2)  # (n2, k2)

    def f32(a):
        return np.ascontiguousarray(a, dtype=np.float32)

    return (n1, n2, f32(d1.real), f32(d1.imag), f32(tw.real), f32(tw.imag),
            f32(d2.real), f32(d2.imag))


def _cfft(re: torch.Tensor, im: torch.Tensor, n: int):
    """Complex FFT over the last axis (length n) by four-step GEMMs, each
    stage one flat (M, K) @ (K, N) product in f32 (four real GEMMs per
    complex one)."""
    n1, n2, *consts = _cfft_consts(n)
    d1r, d1i, twr, twi, d2r, d2i = (torch.as_tensor(c, device=re.device) for c in consts)
    batch = re.shape[:-1]
    # Stage 1: A[.., k1, n2] = sum_n1 D1[k1, n1] x[.., n1, n2], as
    # ((batch * n2), n1) @ (n1, k1).
    xr = re.reshape(*batch, n1, n2).transpose(-1, -2).reshape(-1, n1)
    xi = im.reshape(*batch, n1, n2).transpose(-1, -2).reshape(-1, n1)
    d1r_t, d1i_t = d1r.T, d1i.T
    ar = xr @ d1r_t - xi @ d1i_t
    ai = xr @ d1i_t + xi @ d1r_t
    ar = ar.reshape(*batch, n2, n1).transpose(-1, -2)  # (.., k1, n2)
    ai = ai.reshape(*batch, n2, n1).transpose(-1, -2)
    br = ar * twr - ai * twi
    bi = ar * twi + ai * twr
    # Stage 2: C[.., k1, k2] = sum_n2 B[.., k1, n2] D2[n2, k2].
    br = br.reshape(-1, n2)
    bi = bi.reshape(-1, n2)
    cr = (br @ d2r - bi @ d2i).reshape(*batch, n1, n2)
    ci = (br @ d2i + bi @ d2r).reshape(*batch, n1, n2)
    # Output index k = n1 * k2 + k1: transpose (k1, k2) -> (k2, k1).
    return (cr.transpose(-1, -2).reshape(*batch, n),
            ci.transpose(-1, -2).reshape(*batch, n))


@functools.lru_cache(maxsize=None)
def _pack_consts(n: int):
    """Unpacking twiddles W_N^k for k = 0..N/2, f32 numpy."""
    w = np.exp(-2j * np.pi * np.arange(n // 2 + 1) / n)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def supported(n: int) -> bool:
    """Whether `rfft`/`irfft` of size n run the matmul form (n even, n/2
    factoring into two integers above 1)."""
    return n % 2 == 0 and _cfft_consts(n // 2) is not None


def rfft(x: torch.Tensor, n: int) -> torch.Tensor:
    """Real FFT over the last axis: (..., n) real -> (..., n//2 + 1)
    complex64; `torch.fft.rfft` where `supported(n)` is false."""
    if x.shape[-1] != n:
        raise ValueError(f"rfft: expected last dim {n}, got {x.shape[-1]}")
    if not supported(n):
        return torch.fft.rfft(x, n=n)
    x = x.float()
    with _tf32(x.device, False):
        zr, zi = _cfft(x[..., 0::2], x[..., 1::2], n // 2)
    # X[k] = E[k] + W^k O[k], E = (Z[k] + conj(Z[-k]))/2,
    # O = -i (Z[k] - conj(Z[-k]))/2, with Z[-0] = Z[0].
    zr_full = torch.cat([zr, zr[..., :1]], dim=-1)
    zi_full = torch.cat([zi, zi[..., :1]], dim=-1)
    zr_rev = torch.flip(zr_full, dims=(-1,))
    zi_rev = torch.flip(zi_full, dims=(-1,))
    er = 0.5 * (zr_full + zr_rev)
    ei = 0.5 * (zi_full - zi_rev)
    orr = 0.5 * (zi_full + zi_rev)
    oi = -0.5 * (zr_full - zr_rev)
    wr, wi = (torch.as_tensor(c, device=x.device) for c in _pack_consts(n))
    return torch.complex(er + wr * orr - wi * oi, ei + wr * oi + wi * orr)


def irfft(spec: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse real FFT over the last axis: (..., n//2 + 1) -> (..., n)
    real; `torch.fft.irfft` where `supported(n)` is false."""
    if spec.shape[-1] != n // 2 + 1:
        raise ValueError(f"irfft: expected last dim {n // 2 + 1}, got {spec.shape[-1]}")
    if not supported(n):
        return torch.fft.irfft(spec, n=n)
    half = n // 2
    xr, xi = spec.real.float(), spec.imag.float()
    xr_rev = torch.flip(xr, dims=(-1,))
    xi_rev = torch.flip(xi, dims=(-1,))
    # E[k] = (X[k] + conj(X[N'-k]))/2; W^k O[k] = (X[k] - conj(X[N'-k]))/2.
    er = 0.5 * (xr + xr_rev)
    ei = 0.5 * (xi - xi_rev)
    pr = 0.5 * (xr - xr_rev)
    pi = 0.5 * (xi + xi_rev)
    wr, wi = (torch.as_tensor(c, device=spec.device) for c in _pack_consts(n))
    orr = wr * pr + wi * pi
    oi = wr * pi - wi * pr
    # Z[k] = E[k] + i O[k], k < N/2; ICFFT(Z) = conj(CFFT(conj(Z))) / N'.
    zr = (er - oi)[..., :half]
    zi = (ei + orr)[..., :half]
    with _tf32(spec.device, False):
        cr, ci = _cfft(zr, -zi, half)
    # x[2t] = Re, x[2t+1] = Im.
    out = torch.stack([cr / half, -ci / half], dim=-1)
    return out.reshape(*spec.shape[:-1], n)


# ------------------------------------------------------------ direct rDFT --


def _inverse_weights(n: int, device) -> torch.Tensor:
    """(h, 1): 1/n at DC (and Nyquist for even n), 2/n elsewhere."""
    half = n // 2 + 1
    w = np.full(half, 2.0, np.float32)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    return torch.as_tensor(w, device=device)[:, None] * np.float32(1.0 / n)


def _phase(rows: torch.Tensor, n: int, device) -> torch.Tensor:
    """(len(rows), n//2 + 1) angles 2 pi ((t k) mod n) / n for t in rows."""
    k = torch.arange(n // 2 + 1, dtype=torch.int64, device=device)[None, :]
    return ((rows[:, None] * k) % n).to(torch.float32) * np.float32(2.0 * np.pi / n)


def rdft_matrices_split(n: int, device=None):
    """(cos (n, h), -sin (n, h), inverse re (h, n), inverse im (h, n))."""
    phase = _phase(torch.arange(n, dtype=torch.int64, device=device), n, device)
    cos, nsin = torch.cos(phase), -torch.sin(phase)
    w_col = _inverse_weights(n, device)
    return cos, nsin, w_col * cos.T, w_col * nsin.T


def _rdft_matrices(n: int, device=None):
    """(fwd (n, 2h) = [cos | -sin], inv (2h, n))."""
    cos, nsin, inv_re, inv_im = rdft_matrices_split(n, device)
    return torch.cat([cos, nsin], dim=1), torch.cat([inv_re, inv_im], dim=0)


def rdft(x: torch.Tensor, n: int, impl: str = "dft_high",
         fwd: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Real DFT by one GEMM: (..., n) -> complex64 (..., n//2 + 1)."""
    if fwd is None:
        fwd, _ = _rdft_matrices(n, x.device)
    half = n // 2 + 1
    out = matmul_at(x.reshape(-1, n), fwd, impl).reshape(*x.shape[:-1], 2 * half)
    return torch.complex(out[..., :half], out[..., half:])


def irdft(spec: torch.Tensor, n: int, impl: str = "dft_high",
          inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse real DFT by one GEMM: complex (..., n//2 + 1) -> (..., n)."""
    if inv is None:
        _, inv = _rdft_matrices(n, spec.device)
    parts = torch.cat([spec.real, spec.imag], dim=-1).float()
    return matmul_at(parts.reshape(-1, parts.shape[-1]), inv, impl).reshape(
        *spec.shape[:-1], n
    )


def rdft_ri(x: torch.Tensor, n: int, impl: str = "dft_default", consts=None):
    """Real DFT as (re, im), two GEMMs, no complex dtype."""
    cos, nsin, _, _ = consts if consts is not None else rdft_matrices_split(n, x.device)
    a = x.reshape(-1, n)
    lead = x.shape[:-1]
    return (matmul_at(a, cos, impl).reshape(*lead, -1),
            matmul_at(a, nsin, impl).reshape(*lead, -1))


def irdft_ri(re: torch.Tensor, im: torch.Tensor, n: int, impl: str = "dft_default",
             consts=None) -> torch.Tensor:
    """Inverse real DFT from (re, im), two GEMMs."""
    _, _, inv_re, inv_im = consts if consts is not None else rdft_matrices_split(n, re.device)
    lead = re.shape[:-1]
    out = (matmul_at(re.reshape(-1, re.shape[-1]), inv_re, impl)
           + matmul_at(im.reshape(-1, im.shape[-1]), inv_im, impl))
    return out.reshape(*lead, n)


def rdft_matrices_windowed(n: int, window: np.ndarray, device=None):
    """Returns (lo, w_len, cos_w (w_len, h), nsin_w (w_len, h),
    inv_re_w (h, w_len), inv_im_w (h, w_len)), f32 on `device`.

    [lo, lo + w_len) is the window's support; the analysis matrices carry
    the window on their rows and the synthesis matrices the window and the
    inverse-rDFT weights (1/n at DC and Nyquist, 2/n elsewhere).
    """
    window = np.asarray(window, dtype=np.float32)
    nz = np.nonzero(window)[0]
    lo, hi = int(nz[0]), int(nz[-1]) + 1
    w_len = hi - lo
    phase = _phase(lo + torch.arange(w_len, dtype=torch.int64, device=device), n, device)
    cos = torch.cos(phase)
    nsin = -torch.sin(phase)
    wvals = torch.as_tensor(window[lo:hi], device=device)[:, None]
    w_col = _inverse_weights(n, device)
    return (lo, w_len, cos * wvals, nsin * wvals,
            (w_col * cos.T) * wvals.T, (w_col * nsin.T) * wvals.T)
