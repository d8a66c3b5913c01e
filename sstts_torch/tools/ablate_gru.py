"""The GRU kernels (B3 and its backward) taken apart on the card.

    python3 -m sstts_torch.tools.ablate_gru

Builds `sstts_torch/csrc/gru.cu` as the port builds it and, at the main
paths' shapes (forward b=32, T=800, D=H=128, every step valid; backward
b=32, T=515, ragged lengths), times with CUDA events:

- the input projection alone;
- the forward recurrence alone, with and without saving the gates, by the
  H = 128 kernel and by the generic kernel (which also takes H = 128);
- the whole forward as the wrapper launches it;
- the backward recurrence alone, by both kinds;
- the four cuBLAS products of `_GRUSequence.backward` alone, and the whole
  backward (recurrence and products);
- cuDNN's `nn.GRU` forward and whole backward (forward+backward less
  forward) as the library yardstick.

Before timing, each kind's outputs are held to the plain versions (1e-4,
as `chip_smoke.py` holds them).  Prints what ptxas reported for every
kernel of the file (registers, stack, spills) and one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import json

import torch

from sstts_torch.ops import build, gru
from sstts_torch.tools import card_line, time_ms

KINDS = {"h128": gru.KIND_H128, "generic": gru.KIND_GENERIC}


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gru: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    lib = build.load("gru", gru.SIGNATURES)
    ptxas = build.ptxas_report("gru")
    for name, info in ptxas.items():
        print(f"ptxas {name}: {info}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, *args):
        rc = getattr(lib, fn)(*[a.data_ptr() if torch.is_tensor(a) else a for a in args],
                              stream)
        build.check(lib, rc, fn)

    B, D, H = 32, 128, 128
    g = torch.Generator().manual_seed(1)
    wx = (torch.randn(D, 3 * H, generator=g) / D**0.5).to(dev)
    wh = torch.nn.init.orthogonal_(torch.empty(H, 3 * H), generator=g).to(dev)
    b = (0.1 * torch.randn(3 * H, generator=g)).to(dev)
    res, failed = {}, []

    # ---- forward, T = 800, every step valid
    T = 800
    xs = torch.randn(B, T, D, generator=g).to(dev)
    full = torch.ones(B, T, device=dev)
    gx = torch.empty(B, T, 3 * H, device=dev)
    out = torch.empty(B, T, H, device=dev)
    gates = torch.empty(B, T, 4 * H, device=dev)
    hprev = torch.empty(B, T, H, device=dev)
    ref_out, ref_gates, ref_hprev = gru.gru_sequence_forward_plain(xs, wx, wh, b, full)
    call("sstts_gru_input_proj", xs, wx, b, gx, B * T, D, 3 * H)
    res["proj_max_abs_err"] = float((gx - (xs @ wx + b)).abs().max())
    res["proj_ms"] = time_ms(
        lambda: call("sstts_gru_input_proj", xs, wx, b, gx, B * T, D, 3 * H))
    for name, kind in KINDS.items():
        for save in (False, True):
            args = (gx, wh, full, out, gates if save else None,
                    hprev if save else None, None, B, T, H, 0, kind, 1)
            out.zero_()
            call("sstts_gru_recurrence", *args)
            torch.cuda.synchronize()
            errs = {"out": _rel(out, ref_out)}
            if save:
                errs.update(gates=_rel(gates, ref_gates), hprev=_rel(hprev, ref_hprev))
            key = f"fwd_recurrence_{name}_{'save' if save else 'nosave'}"
            res[key + "_rel_err"] = errs
            if not max(errs.values()) <= 1e-4:
                failed.append(f"{key}: {errs}")
            res[key + "_ms"] = time_ms(lambda: call("sstts_gru_recurrence", *args))
    with torch.no_grad():
        res["fwd_whole_ms"] = time_ms(lambda: gru.gru_sequence(xs, wx, wh, b, full))
    cudnn = torch.nn.GRU(D, H, batch_first=True).to(dev)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(wx.T)
        cudnn.weight_hh_l0.copy_(wh.T)
        cudnn.bias_ih_l0.copy_(b)
        cudnn.bias_hh_l0.zero_()
        res["fwd_cudnn_ms"] = time_ms(lambda: cudnn(xs))

    # ---- backward, T = 515, ragged
    T = 515
    xs = torch.randn(B, T, D, generator=g).to(dev)
    dout = torch.randn(B, T, H, generator=g).to(dev)
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g).to(dev)
    ragged = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    _, gates, hprev = gru.gru_sequence_forward_plain(xs, wx, wh, b, ragged)
    gates, hprev = gates.contiguous(), hprev.contiguous()
    ref = gru.gru_sequence_backward_plain(dout, gates, hprev, wh, ragged)
    dgx = torch.empty(B, T, 3 * H, device=dev)
    dgh = torch.empty_like(dgx)
    for name, kind in KINDS.items():
        args = (dout, gates, hprev, wh, ragged, dgx, dgh, None, B, T, H, 0, kind, 1)
        call("sstts_gru_sequence_backward", *args)
        torch.cuda.synchronize()
        errs = {"dgx": _rel(dgx, ref[0]), "dgh": _rel(dgh, ref[1])}
        res[f"bwd_recurrence_{name}_rel_err"] = errs
        if not max(errs.values()) <= 1e-4:
            failed.append(f"bwd_recurrence_{name}: {errs}")
        res[f"bwd_recurrence_{name}_ms"] = time_ms(
            lambda: call("sstts_gru_sequence_backward", *args))

    def products():
        dxs = dgx @ wx.T
        dwx = xs.reshape(-1, D).T @ dgx.reshape(-1, 3 * H)
        dwh = hprev.reshape(-1, H).T @ dgh.reshape(-1, 3 * H)
        return dxs, dwx, dwh, dgx.sum((0, 1))

    res["bwd_products_ms"] = time_ms(products)
    leaves = [t.clone().requires_grad_() for t in (xs, wx, wh, b)]
    y = gru.gru_sequence(*leaves, ragged)
    res["bwd_whole_ms"] = time_ms(
        lambda: torch.autograd.grad(y, leaves, dout, retain_graph=True))
    res["fwd_save_whole_ms_T515"] = time_ms(lambda: gru.gru_sequence(*leaves, ragged))
    xs_g = xs.clone().requires_grad_()

    def cudnn_fwd_bwd():
        cudnn.zero_grad(set_to_none=True)
        cudnn(xs_g)[0].backward(dout)

    with torch.no_grad():
        cudnn_fwd = time_ms(lambda: cudnn(xs))
    res["bwd_cudnn_whole_ms"] = time_ms(cudnn_fwd_bwd) - cudnn_fwd
    card = card_line()
    print(json.dumps({"gru_ms": res, "ptxas": ptxas,
                      "shapes": {"forward": [B, 800, D, H], "backward": [B, 515, D, H]},
                      "card": card}))
    if failed:
        raise SystemExit("ablate_gru: a kernel disagrees with its plain version: "
                         + "; ".join(failed))


if __name__ == "__main__":
    main()
