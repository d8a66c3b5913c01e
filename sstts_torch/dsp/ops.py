"""Pre-emphasis, dB conversions, block-parallel de-emphasis and the
feature pipeline.

Port of `sstts/dsp/ops.py:24-28` (pre-emphasis), `30-83` (de-emphasis),
`99-113` (dB ops), `116-570` (the device->host wire codecs; the ADPCM rows
decode in C++ where `sstts_torch.data.native_loader` is built, as the
reference's do) and `572-651` (`wav_to_features` with every `fft_impl`).

The direct-DFT features (`fft_impl="dft_*"`, `training.feature_fft_impl`)
take |STFT| as two GEMMs over the window's support with the Hann window
folded into the matrices (`dsp/fft.py:rdft_matrices_windowed`).  The JAX
package runs them outside any Pallas kernel, at an XLA precision rung; on
the card each rung maps to cuBLAS: "dft_highest" f32 with TF32 off;
"dft_high" three TF32 products in place of each f32 one (each operand
split into a part exact in TF32 and the rest: hi*hi + hi*lo + lo*hi, TF32
on for them only and restored after), the counterpart of XLA's HIGH
(three bf16 passes on a TPU); "dft_default" one pass of bf16 operands with f32 accumulation and
f32 results, as XLA's DEFAULT.  One TF32 pass is not enough for "high":
on an H100 (700 W) it put a mel value 9.6e-3 from the f32 features at the
default widths, three products 6.9e-6 (`chip_smoke.py`, phase 3e).  On the
CPU all three run in f32, as XLA:CPU runs every rung.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from sstts_torch.config import DatasetConfig
from sstts_torch.data import native_loader
from sstts_torch.dsp import mel as mel_mod
from sstts_torch.dsp import stft as stft_mod
from sstts_torch.dsp.fft import DFT_IMPLS as _DFT_IMPLS
from sstts_torch.dsp.fft import matmul_at, rdft_matrices_windowed


def preemphasis(y: torch.Tensor, coeff: float) -> torch.Tensor:
    """y'[t] = y[t] - coeff * y[t-1] (y'[0] = y[0]), over the last dim."""
    return y - coeff * torch.nn.functional.pad(y[..., :-1], (1, 0))


def magnitude_to_decibel(x: torch.Tensor) -> torch.Tensor:
    """20 * log10(max(1e-5, x))."""
    return 20.0 * torch.log10(torch.clamp(x, min=1e-5))


def decibel_to_magnitude(db: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, db / 20.0)


def normalize_decibel(db: torch.Tensor, ref_db: float, min_db: float) -> torch.Tensor:
    return torch.clamp((db - ref_db - min_db) / (-min_db), 0.0, 1.0)


def inv_normalize_decibel(s: torch.Tensor, ref_db: float, min_db: float) -> torch.Tensor:
    return torch.clamp(s, 0.0, 1.0) * (-min_db) + min_db + ref_db


@functools.lru_cache(maxsize=None)
def _deemphasis_matrices(coeff: float, block: int, n_blocks: int):
    """Host constants: the in-block zero-state response (Toeplitz, transposed
    for `x @ T`), the block-carry matrix and the in-block decay ramp."""
    i = np.arange(block)
    toeplitz = np.where(
        i[:, None] >= i[None, :],
        np.power(float(coeff), (i[:, None] - i[None, :]).astype(np.float64)),
        0.0,
    ).astype(np.float32)
    # Block boundary states s_b = decay * s_{b-1} + e_b, unrolled:
    # s_b = sum_{c <= b} decay^(b-c) e_c.
    decay = float(coeff) ** block
    bb = np.arange(n_blocks)
    lag = bb[:, None] - bb[None, :]
    with np.errstate(under="ignore"):
        carry = np.where(
            lag >= 0, np.power(decay, np.maximum(lag, 0).astype(np.float64)), 0.0
        ).astype(np.float32)
    ramp = (float(coeff) ** np.arange(1, block + 1, dtype=np.float64)).astype(
        np.float32
    )
    return toeplitz.T.copy(), carry.T.copy(), ramp


def deemphasis(y: torch.Tensor, coeff: float, block: int = 256) -> torch.Tensor:
    """Inverse IIR x[t] = y[t] + coeff * x[t-1], block-parallel, in f32.

    Within a block the zero-state response is one lower-triangular Toeplitz
    matmul; the block boundary states follow s_b = coeff^block * s_{b-1} +
    e_b, a short recurrence over the blocks taken here as one small
    triangular matmul (its decay powers underflow to exact zeros after a few
    blocks, as the scan's products do).
    """
    if coeff == 0.0:
        return y.float()
    n = y.shape[-1]
    n_blocks = -(-n // block)
    pad = n_blocks * block - n
    x = torch.nn.functional.pad(y.float(), (0, pad))
    batch = x.shape[:-1]
    x = x.reshape(*batch, n_blocks, block)
    toeplitz_t, carry_t, ramp = (
        torch.as_tensor(a, device=y.device)
        for a in _deemphasis_matrices(float(coeff), block, n_blocks)
    )
    zs = x @ toeplitz_t
    s = zs[..., -1] @ carry_t  # (..., n_blocks)
    s_prev = torch.nn.functional.pad(s[..., :-1], (1, 0))
    out = zs + s_prev[..., None] * ramp
    return out.reshape(*batch, n_blocks * block)[..., :n]


# --- wire codecs ------------------------------------------------------------
#
# The encoders run on the audio's device in plain torch (the JAX package
# runs them in XLA, without a kernel of its own) and give the JAX package's
# bytes, the same on the card and on the CPU:
#   * XLA fuses `c + a * b` into one multiply-add; the port takes it as the
#     exact f64 product-sum rounded once to f32 (`_fma`);
#   * a division by a constant is a true f32 division (`_div`): torch on
#     CUDA would multiply by the reciprocal of a Python scalar divisor;
#   * mu-law's log1p is taken in f64 and rounded to f32, so both devices
#     agree (XLA's own f32 log1p is not always correctly rounded).
# The decoders are numpy copies of the JAX package's host decoders.

ADPCM_BLOCK = 256


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as a true f32 division on any device."""
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 a * b + c with one rounding (the product of two f32 values is
    exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def mulaw_encode_u8(y: torch.Tensor, mu: float = 255.0) -> torch.Tensor:
    """Continuous mu-law companding of [-1, 1] audio to uint8 (on the
    audio's device); inverse `mulaw_decode_host`.  log1p is taken in f64
    and rounded to f32, so every device gives the same codes."""
    y = torch.clamp(y.float(), -1.0, 1.0)
    lg = torch.log1p((np.float32(mu) * y.abs()).double()).float()
    c = _div(torch.sign(y) * lg, float(np.log1p(mu)))
    return torch.round((c + 1.0) * 127.5).to(torch.uint8)


_MULAW_LUT: dict = {}


def mulaw_decode_host(u8: np.ndarray, mu: float = 255.0) -> np.ndarray:
    """Host (numpy) inverse of `mulaw_encode_u8` -> float32 audio: one
    gather from a 256-entry table."""
    lut = _MULAW_LUT.get(mu)
    if lut is None:
        c = np.arange(256, dtype=np.float32) / 127.5 - 1.0
        lut = (np.sign(c) * (np.expm1(np.abs(c) * np.log1p(mu)) / mu)).astype(np.float32)
        _MULAW_LUT[mu] = lut
    return lut[np.asarray(u8, np.uint8)]


def _dpcm_quantize_blocks(y, q_lo, q_hi, levels, offset=0.0, ns_beta=0.0):
    """Block-adaptive feedback DPCM quantizer (the JAX
    `_dpcm_quantize_blocks`).

    [-1, 1] audio (B, n) -> (codes (B, nb, block) uint8 offset by -q_lo
    with a dummy slot 0, scales (B, nb) f16, seeds (B, nb) i16).  `levels`
    divides the block's largest open-loop delta into the scale; `offset`
    0.5 selects the mid-rise lattice; `ns_beta` > 0 adds first-order
    error-feedback noise shaping (encoder only).  The loop runs over the
    255 in-block positions with every (row, block) pair as one lane.
    """
    block = ADPCM_BLOCK
    y = y.float()
    bsz, n = y.shape
    nb = -(-n // block)
    if nb * block > n:  # edge padding
        y = torch.cat([y, y[:, -1:].expand(bsz, nb * block - n)], dim=1)
    blocks = torch.clamp(y, -1.0, 1.0).reshape(bsz, nb, block)
    seeds = torch.round(blocks[..., 0] * 32767.0).to(torch.int16)
    rec = _div(seeds.float(), 32767.0)
    deltas = blocks[..., 1:] - blocks[..., :-1]
    scale = _div(torch.amax(deltas.abs(), dim=-1), float(levels))
    scale = torch.clamp(scale, min=1e-6).to(torch.float16)
    scale_f = scale.float()
    xs = blocks.permute(2, 0, 1)[1:]  # (block - 1, B, nb)
    qs = []
    if ns_beta:
        beta = -float(np.float32(ns_beta))
        err = torch.zeros_like(rec)
        lim = 2.0 * scale_f
        for u_t in xs:
            tgt = _fma(torch.full_like(err, beta), err, u_t)
            q = torch.clamp(torch.round((tgt - rec) / scale_f - offset), q_lo, q_hi)
            rec = _fma(q + offset, scale_f, rec)
            err = torch.minimum(torch.maximum(rec - tgt, -lim), lim)
            qs.append(q)
    else:
        for u_t in xs:
            q = torch.clamp(torch.round((u_t - rec) / scale_f - offset), q_lo, q_hi)
            rec = _fma(q + offset, scale_f, rec)
            qs.append(q)
    codes = (torch.stack(qs, dim=-1) - q_lo).to(torch.uint8)  # (B, nb, 255)
    dummy = torch.full((bsz, nb, 1), int(-q_lo), dtype=torch.uint8, device=y.device)
    return torch.cat([dummy, codes], dim=-1), scale, seeds


def _wire(packed, scale, seeds):
    """(B, nb, k) packed codes, (B, nb) f16 scales and i16 seeds -> the
    uint8 row layout [codes | scales | seeds] (little-endian)."""
    bsz = packed.shape[0]
    return torch.cat(
        [
            packed.reshape(bsz, -1),
            scale.contiguous().view(torch.uint8).reshape(bsz, -1),
            seeds.contiguous().view(torch.uint8).reshape(bsz, -1),
        ],
        dim=1,
    )


def adpcm4_encode_wire(y: torch.Tensor) -> torch.Tensor:
    """[-1, 1] audio (B, n) -> uint8 wire rows (B, 132 * ceil(n/256)):
    4-bit block-adaptive feedback DPCM, two codes a byte."""
    codes, scale, seeds = _dpcm_quantize_blocks(y, -8.0, 7.0, 7)
    return _wire(codes[..., 0::2] | (codes[..., 1::2] << 4), scale, seeds)


def adpcm3_encode_wire(y: torch.Tensor) -> torch.Tensor:
    """[-1, 1] audio (B, n) -> uint8 wire rows (B, 100 * ceil(n/256)):
    3-bit DPCM, eight codes packed little-endian into 3 bytes."""
    codes, scale, seeds = _dpcm_quantize_blocks(y, -4.0, 3.0, 3)
    bsz, nb, _ = codes.shape
    c = codes.reshape(bsz, nb, ADPCM_BLOCK // 8, 8)
    b0 = c[..., 0] | (c[..., 1] << 3) | ((c[..., 2] & 3) << 6)
    b1 = (c[..., 2] >> 2) | (c[..., 3] << 1) | (c[..., 4] << 4) | ((c[..., 5] & 1) << 7)
    b2 = (c[..., 5] >> 1) | (c[..., 6] << 2) | (c[..., 7] << 5)
    return _wire(torch.stack([b0, b1, b2], dim=-1), scale, seeds)


def adpcm2_encode_wire(y: torch.Tensor, ns_beta: float = 0.0) -> torch.Tensor:
    """[-1, 1] audio (B, n) -> uint8 wire rows (B, 68 * ceil(n/256)):
    2-bit mid-rise DPCM ((code - 1.5) * scale), four codes a byte;
    `ns_beta` shapes the noise without changing the layout."""
    codes, scale, seeds = _dpcm_quantize_blocks(
        y, -2.0, 1.0, 1.5, offset=0.5, ns_beta=ns_beta
    )
    bsz, nb, _ = codes.shape
    c = codes.reshape(bsz, nb, ADPCM_BLOCK // 4, 4)
    packed = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
    return _wire(packed, scale, seeds)


def _split_rows(rows: np.ndarray, code_bytes: int):
    """uint8 wire rows -> (packed codes (B, nb, code_bytes), scales and
    seeds (B, nb, 1) f32)."""
    rows = np.ascontiguousarray(np.atleast_2d(np.asarray(rows, np.uint8)))
    bsz = rows.shape[0]
    nb = rows.shape[1] // (code_bytes + 4)
    npk = nb * code_bytes
    packed = rows[:, :npk].reshape(bsz, nb, code_bytes)
    scales = (
        rows[:, npk : npk + 2 * nb].reshape(-1).view(np.float16)
        .astype(np.float32).reshape(bsz, nb, 1)
    )
    seeds = (
        rows[:, npk + 2 * nb :].reshape(-1).view(np.int16)
        .astype(np.float32).reshape(bsz, nb, 1) / 32767.0
    )
    return packed, scales, seeds


def _integrate(q: np.ndarray, scales, seeds) -> np.ndarray:
    """The decoder's telescoped feedback loop: seed + cumsum(q * scale)."""
    q[..., 0] = 0.0  # dummy slot; sample 0 is the seed itself
    y = seeds + np.cumsum(q * scales, axis=-1)
    return y.reshape(q.shape[0], -1).astype(np.float32)


def _adpcm4_decode_rows_np(rows: np.ndarray) -> np.ndarray:
    """Numpy inverse of `adpcm4_encode_wire` -> (B, n_pad) float32."""
    packed, scales, seeds = _split_rows(rows, ADPCM_BLOCK // 2)
    codes = np.empty(packed.shape[:2] + (ADPCM_BLOCK,), np.float32)
    codes[..., 0::2] = packed & 15
    codes[..., 1::2] = packed >> 4
    return _integrate(codes - 8.0, scales, seeds)


def _adpcm3_decode_rows_np(rows: np.ndarray) -> np.ndarray:
    """Numpy inverse of `adpcm3_encode_wire` -> (B, n_pad) float32."""
    packed, scales, seeds = _split_rows(rows, ADPCM_BLOCK * 3 // 8)
    bsz, nb = packed.shape[:2]
    packed = packed.reshape(bsz, nb, ADPCM_BLOCK // 8, 3)
    b0, b1, b2 = (packed[..., i].astype(np.uint16) for i in range(3))
    codes = np.empty((bsz, nb, ADPCM_BLOCK // 8, 8), np.float32)
    codes[..., 0] = b0 & 7
    codes[..., 1] = (b0 >> 3) & 7
    codes[..., 2] = ((b0 >> 6) | (b1 << 2)) & 7
    codes[..., 3] = (b1 >> 1) & 7
    codes[..., 4] = (b1 >> 4) & 7
    codes[..., 5] = ((b1 >> 7) | (b2 << 1)) & 7
    codes[..., 6] = (b2 >> 2) & 7
    codes[..., 7] = (b2 >> 5) & 7
    return _integrate(codes.reshape(bsz, nb, ADPCM_BLOCK) - 4.0, scales, seeds)


def _adpcm2_decode_rows_np(rows: np.ndarray) -> np.ndarray:
    """Numpy inverse of `adpcm2_encode_wire` -> (B, n_pad) float32."""
    packed, scales, seeds = _split_rows(rows, ADPCM_BLOCK // 4)
    codes = np.empty(packed.shape[:2] + (ADPCM_BLOCK,), np.float32)
    for i in range(4):
        codes[..., i::4] = (packed >> (2 * i)) & 3
    return _integrate(codes - 1.5, scales, seeds)


# The host decoders take the native C++ row decoder where it is built, else
# the numpy one (its oracle: they agree to f32 rounding, ~1e-7).


def adpcm4_decode_host_rows(rows: np.ndarray) -> np.ndarray:
    """Host inverse of `adpcm4_encode_wire` -> (B, n_pad) float32."""
    dec = native_loader.adpcm_decode_rows(rows, 4)
    return _adpcm4_decode_rows_np(rows) if dec is None else dec


def adpcm3_decode_host_rows(rows: np.ndarray) -> np.ndarray:
    """Host inverse of `adpcm3_encode_wire` -> (B, n_pad) float32."""
    dec = native_loader.adpcm_decode_rows(rows, 3)
    return _adpcm3_decode_rows_np(rows) if dec is None else dec


def adpcm2_decode_host_rows(rows: np.ndarray) -> np.ndarray:
    """Host inverse of `adpcm2_encode_wire` -> (B, n_pad) float32."""
    dec = native_loader.adpcm_decode_rows(rows, 2)
    return _adpcm2_decode_rows_np(rows) if dec is None else dec


def adpcm4_decode_host(row: np.ndarray, n_samples: int) -> np.ndarray:
    return adpcm4_decode_host_rows(row[None])[0, :n_samples]


def adpcm3_decode_host(row: np.ndarray, n_samples: int) -> np.ndarray:
    return adpcm3_decode_host_rows(row[None])[0, :n_samples]


def adpcm2_decode_host(row: np.ndarray, n_samples: int) -> np.ndarray:
    return adpcm2_decode_host_rows(row[None])[0, :n_samples]


def adpcm4_wire_bytes(n_samples: int) -> int:
    """Wire row width (bytes) of `adpcm4_encode_wire` for n samples."""
    return -(-n_samples // ADPCM_BLOCK) * (ADPCM_BLOCK // 2 + 4)


def adpcm3_wire_bytes(n_samples: int) -> int:
    """Wire row width (bytes) of `adpcm3_encode_wire` for n samples."""
    return -(-n_samples // ADPCM_BLOCK) * (ADPCM_BLOCK * 3 // 8 + 4)


def adpcm2_wire_bytes(n_samples: int) -> int:
    """Wire row width (bytes) of `adpcm2_encode_wire` for n samples."""
    return -(-n_samples // ADPCM_BLOCK) * (ADPCM_BLOCK // 4 + 4)


WIRE_FORMATS = ("pcm16", "mulaw8", "adpcm4", "adpcm3", "adpcm2")


def encode_wire(wav: torch.Tensor, wire_format: str) -> torch.Tensor:
    """[-1, 1] audio (B, n) -> the device->host wire rows of
    `inference.wire_format` (PCM16 int16, or uint8 for the others)."""
    if wire_format == "mulaw8":
        return mulaw_encode_u8(wav)
    if wire_format == "adpcm4":
        return adpcm4_encode_wire(wav)
    if wire_format == "adpcm3":
        return adpcm3_encode_wire(wav)
    if wire_format == "adpcm2":
        return adpcm2_encode_wire(wav)
    if wire_format == "pcm16":
        return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
    raise ValueError(f"unknown wire_format {wire_format!r}; expected one of {WIRE_FORMATS}")


def decode_wire_rows(rows: np.ndarray, wire_format: str) -> np.ndarray:
    """Host inverse of `encode_wire`: (B, W) wire rows -> (B, n_pad)
    float32 audio (each row is sliced to its sample count by the caller)."""
    if wire_format == "mulaw8":
        return mulaw_decode_host(rows)
    if wire_format == "adpcm4":
        return adpcm4_decode_host_rows(rows)
    if wire_format == "adpcm3":
        return adpcm3_decode_host_rows(rows)
    if wire_format == "adpcm2":
        return adpcm2_decode_host_rows(rows)
    if wire_format == "pcm16":
        return np.multiply(rows, np.float32(1.0 / 32767.0), dtype=np.float32)
    raise ValueError(f"unknown wire_format {wire_format!r}; expected one of {WIRE_FORMATS}")


def _dft_products(seg: torch.Tensor, cos_w: torch.Tensor, nsin_w: torch.Tensor, impl: str):
    """(re, im) = (seg @ cos_w, seg @ nsin_w), f32, at `impl`'s precision
    rung on the card (`fft.matmul_at`); f32 on the CPU."""
    lead = seg.shape[:-1]
    out = matmul_at(seg.reshape(-1, seg.shape[-1]), torch.cat([cos_w, nsin_w], dim=1), impl)
    re, im = out.reshape(*lead, -1).split(cos_w.shape[1], dim=-1)
    return re, im


def _stft_magnitude_dft(y: torch.Tensor, cfg: DatasetConfig, impl: str) -> torch.Tensor:
    """|STFT| as two support-reduced, window-folded DFT GEMMs, with the
    centered STFT's reflect padding and frame count.  The frames are cut at
    the window's support directly from the signal shifted by its start
    (`frame_signal` fits more such frames than n_fft-wide ones; the extra
    ones are dropped)."""
    n_fft, hop = cfg.n_fft, cfg.hop_len
    lead = y.shape[:-1]
    y = torch.nn.functional.pad(
        y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect"
    ).reshape(*lead, -1)
    n_frames = (y.shape[-1] - n_fft) // hop + 1
    lo, w_len, cos_w, nsin_w, _, _ = rdft_matrices_windowed(
        n_fft, stft_mod.window(n_fft, cfg.win_len), device=y.device
    )
    seg = stft_mod.frame_signal(y[..., lo:], w_len, hop)[..., :n_frames, :]
    re, im = _dft_products(seg, cos_w, nsin_w, impl)
    return torch.sqrt(re * re + im * im)


def wav_to_features(
    y: torch.Tensor, cfg: DatasetConfig, fft_impl: str = "default"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n_samples) waveform -> (linear (..., n_frames, n_fft//2+1),
    mel (..., n_frames, n_mels)), both normalized to [0, 1]; one STFT feeds
    both.  `fft_impl`: "default" (`torch.fft`) or a direct-DFT rung."""
    if fft_impl != "default" and fft_impl not in _DFT_IMPLS:
        raise ValueError(
            f"unknown fft_impl {fft_impl!r}; valid: 'default', "
            + ", ".join(repr(k) for k in _DFT_IMPLS)
        )
    y = preemphasis(y.float(), cfg.preemphasis)
    if fft_impl == "default":
        mag = stft_mod.stft(y, cfg.n_fft, cfg.hop_len, cfg.win_len).abs()
    else:
        mag = _stft_magnitude_dft(y, cfg, fft_impl)
    linear = normalize_decibel(magnitude_to_decibel(mag), cfg.ref_level_db, cfg.min_level_db)
    mel = normalize_decibel(
        magnitude_to_decibel(mel_mod.apply_mel(mag, cfg)), cfg.ref_level_db, cfg.min_level_db
    )
    return linear, mel
