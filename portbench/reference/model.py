"""Tacotron (arXiv:1703.10135) in plain PyTorch over a state dict.

char embedding -> pre-net -> CBHG encoder -> attention GRU, Bahdanau
attention, decoder projection, two residual GRUs, r frames a step ->
post-CBHG -> linear spectrogram.  Layouts: (B, T, D) batch-major; Linear
weights (out, in); GRUs with fused (r, z, n) gates, wx (D, 3H), wh (H, 3H),
b (3H,), the candidate r * (h @ Wh_n); convolution banks with SAME padding
((k - 1) // 2 left, k // 2 right); max-pool of width 2, stride 1; batch
norm with epsilon 1e-3 (evaluation: its running statistics; training:
statistics over the valid positions).  Padded positions are masked as
the model defines; a finished utterance's carry freezes and its frames
are zero.

`P.full` is the dtype of every part the configuration states in float32;
the decode's and the teacher-forced scan's products take operands rounded
to `P.half` and accumulate in float32, their gates and softmax float32.
With `straight` the rounding passes its gradient through unrounded
(training: the stated backward is the float32 scan's).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import Precision, philox, round_to

SD = Mapping[str, torch.Tensor]


def _round(x: torch.Tensor, dtype: torch.dtype, straight: bool) -> torch.Tensor:
    r = round_to(x, dtype)
    return x + (r - x).detach() if straight else r


def _dot(x, w, dtype, straight=False):
    return _round(x, dtype, straight) @ _round(w, dtype, straight)


def _lin(x, sd: SD, name: str, dt) -> torch.Tensor:
    w = sd[name + ".weight"].to(dt)
    b = sd.get(name + ".bias")
    return F.linear(x.to(dt), w, None if b is None else b.to(dt))


def _conv(x, w, dt, pad: Tuple[int, int]) -> torch.Tensor:
    xc = F.pad(x.to(dt).transpose(1, 2), pad)
    return F.conv1d(xc, w.to(dt)).transpose(1, 2)


def _bn(x, sd: SD, prefix: str, mask, train: bool, dt) -> torch.Tensor:
    x = x.float()
    if train:
        m = torch.ones(x.shape[:2], device=x.device) if mask is None else mask.float()
        m = m[..., None]
        count = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum((0, 1)) / count
        var = (((x - mean) ** 2) * m).sum((0, 1)) / count
    else:
        mean, var = sd[prefix + ".mean"], sd[prefix + ".var"]
    y = (x - mean) / torch.sqrt(var + 1e-3)
    return (y * sd[prefix + ".scale"] + sd[prefix + ".bias"]).to(dt)


def gru_sequence(xs, sd: SD, prefix: str, mask, reverse: bool, dt) -> torch.Tensor:
    """(B, T, D) -> (B, T, H); the carry freezes and the output is zero on
    padding."""
    wx, wh, b = (sd[f"{prefix}.{n}"].to(dt) for n in ("wx", "wh", "b"))
    B, T, _ = xs.shape
    xs = xs.to(dt)
    h = xs.new_zeros(B, wh.shape[0])
    m = None if mask is None else mask.to(dt)[..., None]
    gx = xs @ wx + b
    hidden = wh.shape[0]
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh = h @ wh
        g = gx[:, t]
        r = torch.sigmoid(g[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(g[:, hidden : 2 * hidden] + gh[:, hidden : 2 * hidden])
        n = torch.tanh(g[:, 2 * hidden :] + r * gh[:, 2 * hidden :])
        h_new = z * h + (1.0 - z) * n
        if m is not None:
            h_new = m[:, t] * h_new + (1.0 - m[:, t]) * h
            ys[t] = m[:, t] * h_new
        else:
            ys[t] = h_new
        h = h_new
    return torch.stack(ys, 1)


def cbhg(x, sd: SD, prefix: str, mask, bank_k: int, highway_layers: int, train: bool,
         dt) -> torch.Tensor:
    m3 = None if mask is None else mask[..., None].to(dt)
    x = x.to(dt)
    residual = x
    xb = x if m3 is None else x * m3
    outs = []
    for k in range(1, bank_k + 1):
        y = _conv(xb, sd[f"{prefix}.bank.conv{k}"], dt, ((k - 1) // 2, k // 2))
        outs.append(F.relu(_bn(y, sd, f"{prefix}.bank.bn{k}", mask, train, dt)))
    y = torch.cat(outs, -1)
    if m3 is not None:
        y = y * m3
    right = F.pad(y[:, 1:], (0, 0, 0, 1), value=float("-inf"))
    y = torch.maximum(y, right)
    if mask is not None:
        y = torch.where(mask[..., None], y, torch.zeros_like(y))
    y = _conv(y, sd[f"{prefix}.proj1.weight"], dt, (1, 1))
    y = F.relu(_bn(y, sd, f"{prefix}.proj1_bn", mask, train, dt))
    if m3 is not None:
        y = y * m3
    y = _conv(y, sd[f"{prefix}.proj2.weight"], dt, (1, 1))
    y = _bn(y, sd, f"{prefix}.proj2_bn", mask, train, dt) + residual
    if f"{prefix}.highway_in.weight" in sd:
        y = _lin(y, sd, f"{prefix}.highway_in", dt)
    for i in range(highway_layers):
        h = F.relu(_lin(y, sd, f"{prefix}.highway{i}.h", dt))
        t = torch.sigmoid(_lin(y, sd, f"{prefix}.highway{i}.t", dt))
        y = h * t + y * (1.0 - t)
    if m3 is not None:
        y = y * m3
    fwd = gru_sequence(y, sd, f"{prefix}.gru.forward_gru", mask, False, dt)
    bwd = gru_sequence(y, sd, f"{prefix}.gru.backward_gru", mask, True, dt)
    return torch.cat([fwd, bwd], -1)


def prenet(x, sd: SD, prefix: str, n_layers: int, keep, rate: float, dt) -> torch.Tensor:
    scale = 1.0 / (1.0 - rate) if rate < 1.0 else 0.0
    for i in range(n_layers):
        x = F.relu(_lin(x, sd, f"{prefix}.fc{i}", dt))
        if keep is not None:
            x = torch.where(keep[i] > 0, x * scale, torch.zeros_like(x))
    return x


def encode(sd: SD, arch: Mapping, ids: torch.Tensor, P: Precision, train: bool = False,
           keep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T) ids -> memory (B, T, 2 H_enc), mask (B, T)."""
    dt = P.full
    mask = ids != 0
    x = F.embedding(ids, sd["embedding.weight"].to(dt))
    x = prenet(x, sd, "encoder_prenet", len(arch["prenet_units"]), keep,
               arch["prenet_dropout"], dt)
    y = cbhg(x, sd, "encoder_cbhg", mask, arch["encoder_bank_k"],
             arch["encoder_highway_layers"], train, dt)
    return y, mask


def _cell(sd: SD):
    """The decoder cell's products as (in, out) matrices and its vectors."""
    t = lambda n: sd[n].transpose(0, 1)  # noqa: E731
    c = "decoder_cell"
    return {
        "w0": t(f"{c}.prenet.fc0.weight"), "b0": sd[f"{c}.prenet.fc0.bias"],
        "w1": t(f"{c}.prenet.fc1.weight"), "b1": sd[f"{c}.prenet.fc1.bias"],
        "attn": [sd[f"{c}.attn_gru.{n}"] for n in ("wx", "wh", "b")],
        "query": t(f"{c}.attention.query_proj.weight"),
        "v": sd[f"{c}.attention.v"], "sb": sd[f"{c}.attention.b"],
        "mem": t(f"{c}.attention.memory_proj.weight"),
        "dec_w": t(f"{c}.dec_proj.weight"), "dec_b": sd[f"{c}.dec_proj.bias"],
        "gru": [[sd[f"{c}.dec_gru{i}.{n}"] for n in ("wx", "wh", "b")] for i in range(2)],
        "frame_w": t(f"{c}.frame_proj.weight"), "frame_b": sd[f"{c}.frame_proj.bias"],
        "stop_w": t(f"{c}.stop_proj.weight"), "stop_b": sd[f"{c}.stop_proj.bias"],
    }


def _gstep(x, h, w, hd, straight):
    wx, wh, b = w
    hidden = h.shape[-1]
    gx = _dot(x, wx, hd, straight) + b.float()
    gh = _dot(h, wh, hd, straight)
    r = torch.sigmoid(gx[:, :hidden] + gh[:, :hidden])
    z = torch.sigmoid(gx[:, hidden : 2 * hidden] + gh[:, hidden : 2 * hidden])
    n = torch.tanh(gx[:, 2 * hidden :] + r * gh[:, 2 * hidden :])
    return z * h + (1.0 - z) * n


def _chain(w, pre, ctx, attn_h, hs, mem, keys, maskf, hd, straight):
    """Attention GRU -> attention -> decoder projection -> residual GRUs."""
    h_a = _gstep(torch.cat([pre, ctx], -1), attn_h, w["attn"], hd, straight)
    q = _dot(h_a, w["query"], hd, straight) + w["sb"].float()
    scores = (torch.tanh(keys + q[:, None, :]) * w["v"].float()).sum(-1)
    scores = torch.where(maskf > 0, scores, torch.full_like(scores, -1e9))
    align = torch.softmax(scores, -1)
    c = torch.einsum("bt,btd->bd", align, mem)
    d = _dot(torch.cat([h_a, c], -1), w["dec_w"], hd, straight) + w["dec_b"].float()
    new = []
    for i, h in enumerate(hs):
        n_i = _gstep(d, h, w["gru"][i], hd, straight)
        new.append(n_i)
        d = d + n_i
    return h_a, align, c, new, d


def decode(sd: SD, arch: Mapping, n_mels: int, memory, mask, steps: int,
           seed: Optional[int], rows, stop_threshold: float, min_steps: int,
           P: Precision) -> Dict[str, torch.Tensor]:
    """The autoregressive decode of `steps` steps with the inference prenet
    dropout of `seed` for global rows `rows`: mel (B, S r, M), n_frames."""
    w = _cell(sd)
    hd = P.half
    B, T, Dm = memory.shape
    r = arch["reduction_factor"]
    dev = memory.device
    mem = _round(memory.float(), hd, False)
    keys = _round(memory.float() @ w["mem"].float(), hd, False)
    maskf = mask.float()
    Ha, Hd = w["attn"][1].shape[0], w["gru"][0][1].shape[0]
    z = lambda n: torch.zeros(B, n, device=dev)  # noqa: E731
    attn_h, hs, ctx, prev = z(Ha), [z(Hd), z(Hd)], z(Dm), z(n_mels)
    fin = z(1)
    rate = arch["prenet_dropout"] if arch["prenet_dropout_at_inference"] else 0.0
    masks = philox.keep_masks(seed, rows, steps, tuple(arch["prenet_units"]), rate, dev)
    scale = philox.dropout_scale(rate)
    mels, fins = [], []
    for t in range(steps):
        done = fin > 0
        x = F.relu(_dot(prev, w["w0"], hd) + w["b0"].float())
        if masks is not None:
            x = torch.where(masks[0][t] > 0, x * scale, torch.zeros_like(x))
        x = F.relu(_dot(x, w["w1"], hd) + w["b1"].float())
        if masks is not None:
            x = torch.where(masks[1][t] > 0, x * scale, torch.zeros_like(x))
        h_a, _, c, new, d = _chain(w, x, ctx, attn_h, hs, mem, keys, maskf, hd, False)
        mel = _dot(d, w["frame_w"], hd) + w["frame_b"].float()
        stop = _dot(d, w["stop_w"], hd) + w["stop_b"].float()
        mel = torch.where(done, torch.zeros_like(mel), mel)
        hit = (torch.sigmoid(stop.max(-1, keepdim=True).values) > stop_threshold).float()
        if t < min_steps - 1:
            hit = torch.zeros_like(hit)
        keep = lambda new_v, old: torch.where(done, old, new_v)  # noqa: E731
        attn_h, ctx = keep(h_a, attn_h), keep(c, ctx)
        hs = [keep(n, o) for n, o in zip(new, hs)]
        prev = keep(mel[:, (r - 1) * n_mels :], prev)
        mels.append(mel)
        fins.append(fin[:, 0])
        fin = torch.maximum(fin, hit)
    fin_all = torch.stack(fins, 1)
    return {"mel": torch.stack(mels, 1).reshape(B, steps * r, n_mels),
            "n_frames": (fin_all < 0.5).sum(1) * r}


def teacher(sd: SD, arch: Mapping, n_mels: int, memory, mask, mel_gt, keep,
            P: Precision) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Teacher-forced decode: step s takes the last ground-truth frame of
    group s - 1 (zeros at s = 0).  The scan's products round their
    operands to `P.half` with the gradient passed through; the prenet and
    the frame and stop projections are float32 parts.  Returns mel
    (B, F, M), stop logits (B, F), alignments (B, S, T)."""
    dt, hd = P.full, P.half
    r = arch["reduction_factor"]
    B, Fr, M = mel_gt.shape
    S = Fr // r
    last = mel_gt.reshape(B, S, r, M)[:, :, -1]
    inputs = F.pad(last[:, :-1], (0, 0, 1, 0))
    pre = prenet(inputs, sd, "decoder_cell.prenet", len(arch["prenet_units"]), keep,
                 arch["prenet_dropout"], dt).float()
    w = _cell(sd)
    mem = _round(memory.float(), hd, True)
    keys = _round(memory.float() @ w["mem"].float(), hd, True)
    maskf = mask.float()
    Ha, Hd, Dm = w["attn"][1].shape[0], w["gru"][0][1].shape[0], memory.shape[-1]
    z = lambda n: memory.new_zeros(B, n, dtype=torch.float32)  # noqa: E731
    attn_h, hs, ctx = z(Ha), [z(Hd), z(Hd)], z(Dm)
    xs, aligns = [], []
    for s in range(S):
        attn_h, align, ctx, hs, d = _chain(w, pre[:, s], ctx, attn_h, hs, mem, keys, maskf,
                                          hd, True)
        xs.append(d)
        aligns.append(align)
    x = torch.stack(xs, 1).to(dt)
    mel = _lin(x, sd, "decoder_cell.frame_proj", dt).reshape(B, S * r, M)
    stops = _lin(x, sd, "decoder_cell.stop_proj", dt).reshape(B, S * r)
    return mel, stops, torch.stack(aligns, 1)


def postnet(sd: SD, arch: Mapping, mel, frame_mask, P: Precision, train: bool = False):
    """(B, F, M) mel -> (B, F, n_linear) normalised linear spectrogram."""
    y = cbhg(mel, sd, "post_cbhg", frame_mask, arch["post_bank_k"],
             arch["post_highway_layers"], train, P.full)
    return _lin(y, sd, "linear_proj", P.full)
