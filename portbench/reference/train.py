"""The reference train step, in plain PyTorch: features from PCM16, the
teacher-forced forward in training mode, the loss, its gradient by
autograd, clipping by the global norm and Adam.

- Rows: an utterance's ids padded to the bucket's text width; its audio
  cut to (frames - 1) hop samples, rounded to PCM16 and zero-padded;
  frames = min(bucket frames, 1 + len(audio) // hop); loss frames =
  max(1, frames - (ceil(n_fft / 2 / hop) + 1)); a fill row has none.
- Features: pre-emphasis, the centred STFT (reflect padding, periodic Hann
  of the window length centred in n_fft), 20 log10(max(|.|, 1e-5)) of the
  magnitude and of its Slaney mel projection, each normalised to [0, 1]
  by (dB - ref - min) / -min.
- Dropout: the program draws its keep masks at step k from a generator of
  the device seeded with ((training.seed + 1) << 32) + k: the encoder
  pre-net's (B, T, P) per layer, then the decoder pre-net's (B, S, P), kept
  where a uniform draw is at least the rate.  The same draws are made here.
- Loss: L1 of the mel and of the linear spectrogram (the linear term
  (1 - w) full + w below loss_low_freq_hz), masked by the loss frames,
  plus the stop token's BCE over loss frames + r (targets 1 from the last
  loss frame on).
- Update: the gradient scaled to norm max_norm where its global norm is
  at least that; Adam (bias-corrected, eps outside the root) at the
  step's learning rate (staircase decay, floor lr_min).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import Precision, matmul_precision, model, text

BUFFERS = (".mean", ".var")


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_hz, min_hz / f_sp + np.log(np.maximum(f, min_hz) / min_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_hz = 200.0 / 3.0, 1000.0
    logstep = np.log(6.4) / 27.0
    min_mel = min_hz / f_sp
    return np.where(m >= min_mel, min_hz * np.exp(logstep * (m - min_mel)), f_sp * m)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalised triangular filters (n_mels, n_fft // 2 + 1)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    return w * (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]


def features(samples: torch.Tensor, ds: Mapping) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n) int16 -> (linear (B, F, bins), mel (B, F, n_mels)) in [0, 1]."""
    n_fft = ds["n_fft"]
    hop = int(ds["sample_rate"] * ds["win_hop_ms"] / 1000.0)
    wl = int(ds["sample_rate"] * ds["win_len_ms"] / 1000.0)
    y = samples.float() * (1.0 / 32767.0)
    y = y - ds["preemphasis"] * F.pad(y[:, :-1], (1, 0))
    n = np.arange(wl, dtype=np.float64)
    win = np.pad(0.5 - 0.5 * np.cos(2 * np.pi * n / wl), ((n_fft - wl) // 2, n_fft - wl - (n_fft - wl) // 2))
    win = torch.as_tensor(win.astype(np.float32), device=y.device)
    yp = F.pad(y[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    mag = torch.fft.rfft(yp.unfold(-1, n_fft, hop) * win, n=n_fft).abs()
    fb = torch.as_tensor(mel_filterbank(ds["sample_rate"], n_fft, ds["n_mels"], ds["mel_fmin"],
                                        ds["mel_fmax"]).astype(np.float32), device=y.device)

    def norm(x):
        db = 20.0 * torch.log10(torch.clamp(x, min=1e-5))
        return torch.clamp((db - ds["ref_level_db"] - ds["min_level_db"]) / (-ds["min_level_db"]),
                           0.0, 1.0)

    return norm(mag), norm(mag @ fb.T)


def make_rows(items: List[Tuple[str, np.ndarray]], text_len: int, n_frames: int, ds: Mapping):
    """The bucket's padded rows of (text, float audio) pairs."""
    hop = int(ds["sample_rate"] * ds["win_hop_ms"] / 1000.0)
    n_samples = (n_frames - 1) * hop
    guard = -(-(ds["n_fft"] // 2) // hop) + 1
    B = len(items)
    ids = np.zeros((B, text_len), np.int64)
    samples = np.zeros((B, n_samples), np.int16)
    frames = np.zeros(B, np.int64)
    loss_frames = np.zeros(B, np.int64)
    for b, (t, audio) in enumerate(items):
        e = text.encode(t)
        ids[b, : len(e)] = e
        a = audio[:n_samples]
        samples[b, : len(a)] = np.round(np.clip(a, -1.0, 1.0) * 32767.0).astype(np.int16)
        nf = min(n_frames, 1 + len(a) // hop)
        frames[b] = nf
        loss_frames[b] = max(1, nf - guard)
    return ids, samples, frames, loss_frames


def dropout_masks(arch: Mapping, seed: int, step: int, B: int, T: int, S: int, device):
    """(encoder pre-net masks, decoder pre-net masks) of train step `step`."""
    g = torch.Generator(device=device).manual_seed(((seed + 1) << 32) + step)
    rate = arch["prenet_dropout"]
    if rate <= 0.0:
        return None, None
    enc = [(torch.rand(B, T, p, generator=g, device=device) >= rate).float()
           for p in arch["prenet_units"]]
    dec = [(torch.rand(B, S, p, generator=g, device=device) >= rate).float()
           for p in arch["prenet_units"]]
    return enc, dec


def loss_fn(out: Dict[str, torch.Tensor], mel_gt, linear_gt, loss_frames, arch: Mapping,
            ds: Mapping) -> torch.Tensor:
    total = mel_gt.shape[1]
    pos = torch.arange(total, device=mel_gt.device)[None]
    mask = (pos < loss_frames[:, None]).float()

    def l1(p, t):
        m = mask[..., None]
        return (torch.abs(p - t) * m).sum() / torch.clamp(m.sum() * p.shape[-1], min=1.0)

    n_linear = ds["n_fft"] // 2 + 1
    n_low = max(1, int(arch["loss_low_freq_hz"] / (ds["sample_rate"] / 2) * n_linear))
    w = arch["loss_low_freq_weight"]
    l_lin = (1.0 - w) * l1(out["linear"], linear_gt) + w * l1(out["linear"][..., :n_low],
                                                               linear_gt[..., :n_low])
    r = arch["reduction_factor"]
    stop_len = torch.where(loss_frames > 0, torch.clamp(loss_frames + r, max=total),
                           torch.zeros_like(loss_frames))
    smask = (pos < stop_len[:, None]).float()
    tgt = (pos >= (loss_frames - 1)[:, None]).float()
    x = out["stop_logits"]
    bce = torch.clamp(x, min=0.0) - x * tgt + torch.log1p(torch.exp(-torch.abs(x)))
    l_stop = (bce * smask).sum() / torch.clamp(smask.sum(), min=1.0)
    return l1(out["mel"], mel_gt) + l_lin + arch["stop_token_weight"] * l_stop


def forward_loss(params: Mapping[str, torch.Tensor], cfg: Mapping, batch, masks,
                 P: Precision) -> torch.Tensor:
    a, ds = cfg["arch"], cfg["dataset"]
    ids, samples, frames, loss_frames = batch
    linear_gt, mel_gt = features(samples, ds)
    total = mel_gt.shape[1]
    fmask = torch.arange(total, device=ids.device)[None] < frames[:, None]
    enc_keep, dec_keep = masks
    memory, mmask = model.encode(params, a, ids, P, train=True, keep=enc_keep)
    mel, stops, align = model.teacher(params, a, ds["n_mels"], memory, mmask, mel_gt, dec_keep, P)
    linear = model.postnet(params, a, mel, fmask, P, train=True)
    out = {"mel": mel.float(), "linear": linear.float(), "stop_logits": stops.float()}
    return loss_fn(out, mel_gt, linear_gt, loss_frames, a, ds)


def lr_at(training: Mapping, step: int) -> float:
    if step <= 0:
        return training["learning_rate"]
    v = training["learning_rate"] * training["lr_decay_rate"] ** (step // training["lr_decay_steps"])
    return max(v, training["lr_min"]) if training["lr_decay_rate"] < 1.0 else min(v, training["lr_min"])


def train_steps(sd: Mapping[str, torch.Tensor], cfg: Mapping, batches: List[tuple],
                P: Precision, device) -> Dict[str, object]:
    """Run len(batches) steps from `sd`; returns each step's loss, the
    first step's clipped gradient per parameter and each parameter's
    change over all the steps (norms, by name)."""
    t = cfg["training"]
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in sd.items() if not k.endswith(BUFFERS)}
    fixed = {k: v for k, v in sd.items() if k.endswith(BUFFERS)}
    start = {k: v.detach().clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = t["adam_beta1"], t["adam_beta2"], t["adam_eps"]
    losses, grad1 = [], {}
    a = cfg["arch"]
    r = a["reduction_factor"]
    with matmul_precision(P):
        for k, (bt, valid) in enumerate(batches):
            ids, samples, frames, lf = (torch.as_tensor(x, device=device) for x in bt)
            lf = torch.where(torch.as_tensor(valid, device=device) > 0, lf, torch.zeros_like(lf))
            B, T = ids.shape
            S = (samples.shape[1] // int(cfg["dataset"]["sample_rate"] * cfg["dataset"]["win_hop_ms"]
                                         / 1000.0) + 1) // r
            masks = dropout_masks(a, t["seed"], k, B, T, S, device)
            loss = forward_loss({**params, **fixed}, cfg, (ids, samples, frames, lf), masks, P)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g.float()
                     for g, p in zip(grads, params.values())]
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = 1.0 if float(norm) < t["grad_clip_norm"] else t["grad_clip_norm"] / float(norm)
            lr = lr_at(t, k)
            with torch.no_grad():
                for (name, p), g in zip(params.items(), grads):
                    g = g * scale
                    if k == 0:
                        grad1[name] = float(torch.linalg.vector_norm(g))
                    m[name].mul_(b1).add_(g, alpha=1 - b1)
                    v2[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                    c1, c2 = 1 - b1 ** (k + 1), 1 - b2 ** (k + 1)
                    denom = v2[name].sqrt() / math.sqrt(c2) + eps
                    p.addcdiv_(m[name], denom, value=-lr / c1)
            losses.append(float(loss.detach()))
    delta = {k: float(torch.linalg.vector_norm(params[k].detach() - start[k])) for k in params}
    return {"loss": losses, "grad1": grad1, "delta": delta}
