"""From a normalised linear spectrogram to the audio on the wire, in plain
PyTorch and NumPy.

- dB: s in [0, 1] -> 100 s - 80 dB -> magnitude, raised to the
  Griffin-Lim power.
- Griffin-Lim (the configuration's "dft_default" loop): zero-phase start;
  an iteration synthesises the frames over the window's support from the
  spectrum (the inverse real DFT with the window folded in), overlap-adds
  them, trims the centre and divides by the squared-window envelope, takes
  the centred analysis frames of that signal (reflect padding of n_fft / 2)
  over the window's support, their real DFT with the window folded in,
  and puts the target magnitude under the new phase (with momentum m,
  over s + m (s - s_prev)).  Both DFT products round their operands to
  the loop's type (`round_to`: float8 with a scale a tensor) and
  accumulate in float32; the spectrum is kept in that type.  In the bfloat16 loop an even n_fft's Nyquist bin rides in DC's
  imaginary lane, the pair normalised by its joint magnitude; the final
  synthesis unpacks it and runs in float32 with the exact magnitude.
- De-emphasis: x[t] = y[t] + c x[t - 1], in float64.
- The wire: PCM16 (round(clamp(y, -1, 1) 32767)) or ADPCM4, a 4-bit
  block-adaptive feedback DPCM (blocks of 256 samples: an int16 seed, an
  f16 scale of the block's largest delta over 7, codes in [-8, 7]), and
  the host's decoding of each.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import round_to


def spectrogram_to_magnitude(linear_norm, ds, inf) -> torch.Tensor:
    db = torch.clamp(linear_norm.float(), 0.0, 1.0) * (-ds["min_level_db"]) + (
        ds["min_level_db"] + ds["ref_level_db"])
    return torch.pow(10.0, db / 20.0) ** inf["griffin_lim_power"]


def _window(n_fft: int, wl: int) -> np.ndarray:
    n = np.arange(wl, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / wl)
    lpad = (n_fft - wl) // 2
    return np.pad(w, (lpad, n_fft - wl - lpad))


def _inv_envelope(n_fft: int, hop: int, wl: int, n_frames: int, length: int) -> np.ndarray:
    w2 = _window(n_fft, wl) ** 2
    wss = np.zeros((n_frames - 1) * hop + n_fft)
    for i in range(n_frames):
        wss[i * hop : i * hop + n_fft] += w2
    inv = np.where(wss > 1e-10, 1.0 / np.maximum(wss, 1e-10), 1.0)
    return inv[n_fft // 2 : n_fft // 2 + length].astype(np.float32)


def _dft_matrices(n_fft: int, wl: int, device):
    """(lo, w_len, cos_w (w_len, h), nsin_w, inv_re_w (h, w_len), inv_im_w)
    over the window's support, window folded in, float32."""
    win = _window(n_fft, wl).astype(np.float32).astype(np.float64)
    nz = np.nonzero(win)[0]
    lo, w_len = int(nz[0]), int(nz[-1]) + 1 - int(nz[0])
    n = lo + np.arange(w_len, dtype=np.int64)
    k = np.arange(n_fft // 2 + 1, dtype=np.int64)
    phase = ((n[:, None] * k[None, :]) % n_fft) * (2.0 * np.pi / n_fft)
    wv = win[lo : lo + w_len, None]
    cos, nsin = np.cos(phase) * wv, -np.sin(phase) * wv
    wcol = np.full(n_fft // 2 + 1, 2.0 / n_fft)
    wcol[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        wcol[-1] = 1.0 / n_fft
    inv_re, inv_im = wcol[:, None] * cos.T, wcol[:, None] * nsin.T
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return lo, w_len, t(cos), t(nsin), t(inv_re), t(inv_im)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    B, n_frames, n = frames.shape
    total = (n_frames - 1) * hop + n
    y = F.fold(frames.transpose(1, 2), output_size=(1, total), kernel_size=(1, n),
               stride=(1, hop))
    return y.reshape(B, total)


def griffin_lim(mag: torch.Tensor, n_fft: int, hop: int, wl: int, iters: int,
                momentum: float, loop: torch.dtype) -> torch.Tensor:
    """(B, n_frames, n_fft // 2 + 1) magnitude -> (B, (n_frames - 1) hop)."""
    dev = mag.device
    B, n_frames, half = mag.shape
    length = (n_frames - 1) * hop
    lo, w_len, cos_w, nsin_w, inv_re, inv_im = _dft_matrices(n_fft, wl, dev)
    start = n_fft // 2 - lo
    inv_env = torch.as_tensor(_inv_envelope(n_fft, hop, wl, n_frames, length), device=dev)

    def synth_signal(frames):
        y = _overlap_add(frames, hop)
        return y[:, start : start + length] * inv_env

    def analysis_frames(y):
        yp = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
        return yp.unfold(-1, n_fft, hop)[:, :n_frames, lo : lo + w_len]

    packed = loop != torch.float32 and n_fft % 2 == 0 and half % 2 == 1 and half > 2
    hb = half - 1 if packed else half
    if packed:
        w_inv = torch.cat([inv_re[:hb], inv_re[hb:], inv_im[1:hb]], 0)
        w_fwd = torch.cat([cos_w[:, :hb], cos_w[:, hb:], nsin_w[:, 1:hb]], 1)
        mag_i = torch.cat([mag[..., hb:], mag[..., 1:hb]], -1)
        q_im0 = F.pad(mag[..., hb:], (0, hb - 1))
    else:
        w_inv = torch.cat([inv_re, inv_im], 0)
        w_fwd = torch.cat([cos_w, nsin_w], 1)
        mag_i = mag
        q_im0 = torch.zeros_like(mag)
    r = lambda x: round_to(x, loop)  # noqa: E731
    w_inv, w_fwd = r(w_inv), r(w_fwd)
    mag2 = r(torch.cat([mag[..., :hb], mag_i], -1))
    q = r(torch.cat([mag[..., :hb], q_im0], -1))
    prev = torch.zeros_like(q)
    m32 = float(np.float32(momentum))
    for _ in range(iters):
        frames = r(q @ w_inv)
        fr = r(analysis_frames(synth_signal(frames)))
        s = fr @ w_fwd
        ex = s + m32 * (s - prev) if momentum > 0.0 else s
        prev = r(s)
        sr, si = ex[..., :hb], ex[..., hb:]
        inv = torch.rsqrt(sr * sr + si * si + 1e-24)
        q = r(ex * torch.cat([inv, inv], -1) * mag2)
    qr, qi = q[..., :hb], q[..., hb:]
    if packed:
        zero = torch.zeros_like(qr[..., :1])
        sr = torch.cat([qr, qi[..., :1]], -1)
        si = torch.cat([zero, qi[..., 1:hb], zero], -1)
    else:
        sr, si = qr, qi
    inv = torch.rsqrt(sr * sr + si * si + 1e-24)
    frames = (mag * sr * inv) @ inv_re + (mag * si * inv) @ inv_im
    return synth_signal(frames)


def deemphasis(y: torch.Tensor, coeff: float, block: int = 256) -> torch.Tensor:
    """x[t] = y[t] + coeff x[t - 1] in float64, a block at a time."""
    if coeff == 0.0:
        return y.float()
    B, n = y.shape
    nb = -(-n // block)
    yb = F.pad(y.double(), (0, nb * block - n)).reshape(B, nb, block)
    i = torch.arange(block, device=y.device)
    lag = (i[:, None] - i[None, :]).double()
    toe = torch.where(lag >= 0, coeff ** lag.clamp(min=0), torch.zeros_like(lag))
    zs = yb @ toe.T
    ramp = coeff ** torch.arange(1, block + 1, device=y.device, dtype=torch.float64)
    out = torch.empty_like(zs)
    carry = torch.zeros(B, dtype=torch.float64, device=y.device)
    for b in range(nb):
        out[:, b] = zs[:, b] + carry[:, None] * ramp
        carry = out[:, b, -1]
    return out.reshape(B, nb * block)[:, :n].float()


# ------------------------------------------------------------------ wire --

_BLOCK = 256


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _div(x, c: float):
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


def adpcm4_encode(y: torch.Tensor):
    """[-1, 1] audio (B, n) -> (codes (B, nb, 256) float in [-8, 7], slot 0
    unused; scales (B, nb) float16; seeds (B, nb) int16)."""
    y = y.float()
    B, n = y.shape
    nb = -(-n // _BLOCK)
    if nb * _BLOCK > n:
        y = torch.cat([y, y[:, -1:].expand(B, nb * _BLOCK - n)], 1)
    blocks = torch.clamp(y, -1.0, 1.0).reshape(B, nb, _BLOCK)
    seeds = torch.round(blocks[..., 0] * 32767.0).to(torch.int16)
    rec = _div(seeds.float(), 32767.0)
    deltas = blocks[..., 1:] - blocks[..., :-1]
    scale = torch.clamp(_div(torch.amax(deltas.abs(), -1), 7.0), min=1e-6).to(torch.float16)
    sf = scale.float()
    codes = [torch.zeros_like(rec)]
    for u in blocks.permute(2, 0, 1)[1:]:
        q = torch.clamp(torch.round((u - rec) / sf), -8.0, 7.0)
        rec = _fma(q, sf, rec)
        codes.append(q)
    return torch.stack(codes, -1), scale, seeds


def adpcm4_decode(codes: np.ndarray, scale: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """The host's decoding: seed + cumulative sum of code x scale."""
    q = codes.astype(np.float32).copy()
    q[..., 0] = 0.0
    s = scale.astype(np.float32)[..., None]
    y = seeds.astype(np.float32)[..., None] / 32767.0 + np.cumsum(q * s, axis=-1)
    return y.reshape(q.shape[0], -1).astype(np.float32)


def through_wire(wav: torch.Tensor, wire: str) -> np.ndarray:
    """(B, n) audio on the device -> (B, n) float32 on the host as the
    wire delivers it."""
    n = wav.shape[1]
    if wire == "pcm16":
        q = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
        return np.multiply(q, np.float32(1.0 / 32767.0), dtype=np.float32)
    if wire == "adpcm4":
        codes, scale, seeds = adpcm4_encode(wav)
        out = adpcm4_decode(codes.cpu().numpy(), scale.cpu().numpy(), seeds.cpu().numpy())
        return out[:, :n]
    raise ValueError(f"no reference for wire {wire!r}")
