"""Whole-sequence GRU: the port of `sstts/ops/pallas_gru.py` (kernel B3).

`gru_sequence` dispatches on the tensor's device: a CPU tensor runs the
plain version (`gru_sequence_plain`, the counterpart of JAX's
`gru_sequence_xla` scan oracle); a CUDA tensor launches the hand-written
kernel in `sstts_torch/csrc/gru.cu`, or raises.  There is no fallback from
one to the other.  Layouts match the JAX package: xs (B, T, D), wx (D, 3H),
wh (H, 3H), b (3H,), mask (B, T), gate order r, z, n.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sstts_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sstts_gru_sequence": ([_P] * 7 + [_I] * 5 + [_P], _I),
    "sstts_gru_smem_bytes": ([_I], _I),
}


def gru_step_math(x, h, wx, wh, b):
    """Fused-gate GRU step; the candidate uses the r * (h @ U_n) form."""
    hidden = h.shape[-1]
    gx = x @ wx + b
    gh = h @ wh
    xr, xz, xn = gx[..., :hidden], gx[..., hidden : 2 * hidden], gx[..., 2 * hidden :]
    hr, hz, hn = gh[..., :hidden], gh[..., hidden : 2 * hidden], gh[..., 2 * hidden :]
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return z * h + (1.0 - z) * n


def gru_sequence_plain(
    xs: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """Step loop with the kernel's semantics (any device; f32)."""
    batch, t_len, _ = xs.shape
    hidden = wh.shape[0]
    xs = xs.float()
    m = None if mask is None else mask.float()
    h = xs.new_zeros(batch, hidden)
    ys = [None] * t_len
    steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
    for t in steps:
        h_new = gru_step_math(xs[:, t], h, wx, wh, b)
        if m is not None:
            mt = m[:, t, None]
            h_new = mt * h_new + (1.0 - mt) * h
            ys[t] = mt * h_new
        else:
            ys[t] = h_new
        h = h_new
    return torch.stack(ys, dim=1)


def _kernel(xs, wx, wh, b, mask, reverse):
    batch, t_len, d_in = xs.shape
    hidden = wh.shape[0]
    if tuple(wx.shape) != (d_in, 3 * hidden) or tuple(wh.shape) != (
        hidden, 3 * hidden
    ) or tuple(b.shape) != (3 * hidden,):
        raise ValueError(
            f"gru_sequence: shapes xs {tuple(xs.shape)}, wx {tuple(wx.shape)},"
            f" wh {tuple(wh.shape)}, b {tuple(b.shape)} do not agree"
        )
    lib = build.load("gru", _SIGNATURES)
    smem = lib.sstts_gru_smem_bytes(hidden)
    if smem > build.MAX_SMEM or 3 * hidden > 1024:
        raise NotImplementedError(
            f"gru_sequence CUDA kernel keeps Wh in shared memory: H={hidden} "
            f"needs {smem} bytes (limit {build.MAX_SMEM}); H <= 137 is supported"
        )
    dev = xs.device
    xs_c = xs.float().contiguous()
    wx_c = wx.float().contiguous()
    wh_c = wh.float().contiguous()
    b_c = b.float().contiguous()
    m_c = None if mask is None else mask.to(dev, torch.float32).contiguous()
    gx = torch.empty(batch, t_len, 3 * hidden, device=dev, dtype=torch.float32)
    out = torch.empty(batch, t_len, hidden, device=dev, dtype=torch.float32)
    rc = lib.sstts_gru_sequence(
        xs_c.data_ptr(), wx_c.data_ptr(), wh_c.data_ptr(), b_c.data_ptr(),
        None if m_c is None else m_c.data_ptr(), gx.data_ptr(),
        out.data_ptr(), batch, t_len, d_in, hidden, int(bool(reverse)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "gru_sequence")
    return out


def gru_sequence(
    xs: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """(B, T, D) inputs -> (B, T, H) GRU outputs (f32).

    CPU tensors run `gru_sequence_plain`; CUDA tensors launch the kernel
    (and count the launch in `gru_sequence.launches`).
    """
    if xs.device.type == "cpu":
        return gru_sequence_plain(xs, wx, wh, b, mask, reverse)
    if xs.device.type != "cuda":
        raise NotImplementedError(f"gru_sequence on {xs.device.type}")
    out = _kernel(xs, wx, wh, b, mask, reverse)
    gru_sequence.launches += 1
    return out


gru_sequence.launches = 0
