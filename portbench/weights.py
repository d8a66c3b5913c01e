"""Seeded random weights for the benchmark, made on the device.

The layout is the program's (`Tacotron(cfg.arch, cfg.dataset)`'s
`state_dict`, read from a model built on the host: building it on the
"meta" device takes seconds more); the values
follow the initialiser families of the program's seeded init (LeCun-normal
kernels, orthogonal recurrent matrices, zero biases, highway gate bias -1,
Bahdanau v ~ U(-1, 1) / sqrt(A), batch norm at mean 0 and variance 1), drawn
from one `torch.Generator` on the device in a few large calls.

One change from that init, stated in each configuration file under
`assumed`: a random init's linear spectrogram sits near 0 in normalised dB
(-80 dB), so its audio (~1e-5) lies below one PCM16 step.  The output
projection's bias is set to a speech-like level and tilt (0.72 at DC to
0.57 at Nyquist in normalised dB units) and its kernel scaled by 0.25, so
that the waveforms on the wire are at a speaking level (about -24 dBFS RMS).
"""

from __future__ import annotations

import re
from typing import Dict

import torch

_LINEAR_LEVEL = (0.72, 0.57)
_LINEAR_SCALE = 0.25


def _family(name: str, shape) -> str:
    if name == "embedding.weight":
        return "normal"
    if name.endswith(".wh"):
        return "orthogonal"
    if name.endswith(".wx") or name.endswith(".weight") or re.search(r"\.conv\d+$", name):
        return "lecun"
    if name.endswith("attention.v"):
        return "uniform"
    if name.endswith(".var") or name.endswith(".scale"):
        return "one"
    if name.endswith(".t.bias"):
        return "minus_one"
    return "zero"


def _fan_in(name: str, shape) -> int:
    if name.endswith(".wx"):
        return shape[0]
    if len(shape) == 3:  # conv (out, in, k)
        return shape[1] * shape[2]
    return shape[1]


def layout(cfg) -> Dict[str, torch.Size]:
    """Parameter and buffer names and shapes of the program's model."""
    from sstts_torch.model.tacotron import Tacotron

    return {k: v.shape for k, v in Tacotron(cfg.arch, cfg.dataset).state_dict().items()}


def make_state_dict(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights for `shapes` on `device`, from `seed` alone."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    fam = {k: _family(k, s) for k, s in shapes.items()}
    numel = {k: int(torch.Size(s).numel()) for k, s in shapes.items()}

    def draw(kind: str):
        keys = [k for k in shapes if fam[k] == kind]
        total = sum(numel[k] for k in keys)
        if kind == "uniform":
            flat = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
        else:
            flat = torch.randn(total, generator=g, device=device)
        out, off = {}, 0
        for k in keys:
            out[k] = flat[off : off + numel[k]].view(shapes[k])
            off += numel[k]
        return out

    sd: Dict[str, torch.Tensor] = {}
    for k, t in draw("normal").items():
        sd[k] = t
    for k, t in draw("lecun").items():
        sd[k] = t * _fan_in(k, shapes[k]) ** -0.5
    for k, t in draw("uniform").items():
        sd[k] = t * shapes[k][0] ** -0.5
    # Orthogonal (H, 3H): rows orthonormal, from the QR of a (3H, H) draw,
    # signs fixed by R's diagonal; one batched QR per shape.
    ortho = draw("orthogonal")
    by_shape: Dict[tuple, list] = {}
    for k in ortho:
        by_shape.setdefault(tuple(shapes[k]), []).append(k)
    for shape, keys in by_shape.items():
        a = torch.stack([ortho[k].reshape(shape[1], shape[0]) for k in keys])
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
        for i, k in enumerate(keys):
            sd[k] = q[i].transpose(0, 1).contiguous()
    for k, s in shapes.items():
        if fam[k] in ("one", "minus_one", "zero"):
            value = {"one": 1.0, "minus_one": -1.0, "zero": 0.0}[fam[k]]
            sd[k] = torch.full(tuple(s), value, device=device)
    bias = sd["linear_proj.bias"]
    sd["linear_proj.bias"] = torch.linspace(*_LINEAR_LEVEL, bias.numel(), device=device)
    sd["linear_proj.weight"] = sd["linear_proj.weight"] * _LINEAR_SCALE
    return {k: sd[k].contiguous() for k in shapes}
