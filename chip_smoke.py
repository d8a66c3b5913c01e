#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`sstts_torch`) on one NVIDIA card.

    python3 chip_smoke.py     # needs one CUDA card

Phases, in order; any failure is an uncaught exception and a non-zero exit:

0. the card's name and power limit (nvidia-smi), torch/CUDA/nvcc versions;
1. build every kernel from `sstts_torch/csrc/` (one nvcc per source, all
   started together) into the git-ignored `sstts_torch/_build/`;
2. each kernel against its plain PyTorch version, on the card, at the main
   paths' shapes, with the tolerance stated beside each check; median times
   from CUDA events for the kernel, its plain version and, where one
   PyTorch call computes the same function, that call; and the bounds of
   the two kernels still to port, from their shapes;
3. the synthesis path: `Synthesizer.synthesize_batch` at the full default
   `Config()` from a seeded random init, bench.py's workload (32 x an 88
   character text, 160 decoder steps = 800 frames, stop threshold 1.1,
   classic Griffin-Lim-60, PCM16): one warm-up batch, then one timed batch
   with every launch counter set to 0 just before and read just after
   (4 GRU, 1 decode, 60 Griffin-Lim launches); then the same text on a
   tiny config on the card against the plain versions on the CPU; one
   batch with the fast vocoder (GL-30 at momentum 0.99), which runs the
   Griffin-Lim kernel's momentum variant; and one main-path batch under
   torch.profiler for the device time by kernel and the busy share;
3b. the training path at the full default `Config()` on the synthetic
   corpus: b=32 in the (128 characters, 515 frames) bucket, 103 decoder
   steps; one warm-up train step, then 5 timed steps on one fixed batch
   with the counters set to 0 just before and read just after (4 GRU
   forward, 4 GRU backward, 1 teacher scan per step); the loss finite at
   every step and lower at the 5th than at the 1st; one profiled step; one
   eval step (4/0/1); a checkpoint, `Synthesizer.from_checkpoint` and two
   utterances from it; and a tiny config's train step on the card (kernels,
   f32 teacher products) against the same step on the CPU (plain versions);
4. one JSON line of every kernel's numbers, the card's line before it, and
   last `{"ok": true, "device": {...}}`.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: Published peaks of one H100 SXM (NVIDIA data sheet, dense): bytes/s of
#: HBM3 and operations/s by operand type.  A card set below 700 W runs
#: below them; its power limit is printed beside every time.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median over `reps` of the mean time of `iters` back-to-back calls,
    from CUDA events (after two warm-up calls)."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float, op_type: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[op_type] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ---------------------------------------------------------------- phase 2 --


def check_gru(dev):
    import torch

    from sstts_torch.ops.gru import gru_sequence, gru_sequence_plain

    B, T, D, H = 32, 800, 128, 128
    g = torch.Generator().manual_seed(1)
    xs = torch.randn(B, T, D, generator=g).to(dev)
    wx = (torch.randn(D, 3 * H, generator=g) / D**0.5).to(dev)
    wh = torch.nn.init.orthogonal_(torch.empty(H, 3 * H), generator=g).to(dev)
    b = (0.1 * torch.randn(3 * H, generator=g)).to(dev)
    lengths = torch.randint(400, T + 1, (B,), generator=g).to(dev)
    ragged = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    full = torch.ones(B, T, device=dev)
    # f32 both sides, 800 dependent steps, sums in another order: 1e-4.
    tol = 1e-4
    checks = []
    for mask_name, mask in (("ragged", ragged), ("full", full)):
        for reverse in (False, True):
            got = gru_sequence(xs, wx, wh, b, mask, reverse)
            ref = gru_sequence_plain(xs, wx, wh, b, mask, reverse)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            case = f"{mask_name}-{'rev' if reverse else 'fwd'}"
            log(f"  B3 gru_sequence {case}: max_abs_err {err:.3e} (tol {tol})")
            if not err <= tol:
                raise AssertionError(f"gru_sequence {case}: {err} > {tol}")
            checks.append({"case": case, "max_abs_err": err, "tol": tol})
    # Main-path call: post-CBHG direction, all frames valid.
    ms = cuda_ms(lambda: gru_sequence(xs, wx, wh, b, full, False))
    plain = cuda_ms(lambda: gru_sequence_plain(xs, wx, wh, b, full, False), 1, 3)
    # One PyTorch call with the same function when every step is valid:
    # cuDNN's GRU (gates r, z, n; r multiplies h @ W_hn + b_hn, b_hn = 0).
    lib = torch.nn.GRU(D, H, batch_first=True).to(dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(wx.T)
        lib.weight_hh_l0.copy_(wh.T)
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
        lib_out = lib(xs)[0]
        lib_err = max_err(lib_out, gru_sequence(xs, wx, wh, b, full, False))
        lib_ms = cuda_ms(lambda: lib(xs))
    log(f"  B3 cuDNN nn.GRU vs kernel (full mask): max_abs_err {lib_err:.3e}")
    n_bytes = nbytes(xs, wx, wh, b, full) + B * T * H * 4
    n_ops = 2 * B * T * (D * 3 * H + H * 3 * H)
    bms, by = bound_ms(n_bytes, n_ops, "f32")
    return {
        "name": "gru_sequence", "route": "cuda",
        "source": "sstts_torch/csrc/gru.cu",
        "replaces": "sstts/ops/pallas_gru.py:69",
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "shape": [B, T, D, H], "checks": checks,
    }


def check_gru_backward(dev):
    """B3's backward recurrence against its plain version, and the gates the
    forward kernel saves for it against the plain forward's, at the
    encoder's (T=128) and the post-CBHG's (T=515) training lengths."""
    import torch

    from sstts_torch.ops import gru
    from sstts_torch.ops.gru import (
        gru_sequence_backward, gru_sequence_backward_plain, gru_sequence_forward_plain,
    )

    B, D, H = 32, 128, 128
    g = torch.Generator().manual_seed(11)
    wx = (torch.randn(D, 3 * H, generator=g) / D**0.5).to(dev)
    wh = torch.nn.init.orthogonal_(torch.empty(H, 3 * H), generator=g).to(dev)
    b = (0.1 * torch.randn(3 * H, generator=g)).to(dev)
    # f32 both sides; 515 dependent steps in another summation order, held
    # relative to the largest value: 1e-4.
    tol = 1e-4
    checks, main = [], None
    for T in (128, 515):
        xs = torch.randn(B, T, D, generator=g).to(dev)
        dout = torch.randn(B, T, H, generator=g).to(dev)
        lengths = torch.randint(T // 2, T + 1, (B,), generator=g).to(dev)
        ragged = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
        for mask_name, mask in (("ragged", ragged), ("full", torch.ones(B, T, device=dev))):
            for reverse in (False, True):
                _, gates, hprev = gru._kernel(xs, wx, wh, b, mask, reverse, save=True)
                _, gates_p, hprev_p = gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
                got = gru_sequence_backward(dout, gates, hprev, wh, mask, reverse)
                ref = gru_sequence_backward_plain(dout, gates, hprev, wh, mask, reverse)
                torch.cuda.synchronize()
                errs = {
                    "gates": max_err(gates, gates_p) / float(gates_p.abs().max()),
                    "hprev": max_err(hprev, hprev_p) / max(float(hprev_p.abs().max()), 1e-30),
                    "dgx": max_err(got[0], ref[0]) / float(ref[0].abs().max()),
                    "dgh": max_err(got[1], ref[1]) / float(ref[1].abs().max()),
                }
                case = f"T{T}-{mask_name}-{'rev' if reverse else 'fwd'}"
                log(f"  B3 backward {case}: relative errors {errs} (tol {tol})")
                if not max(errs.values()) <= tol:
                    raise AssertionError(f"gru_sequence_backward {case}: {errs}")
                abs_err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
                checks.append({"case": case, "max_abs_err": abs_err, "rel_errors": errs, "tol": tol})
                if T == 515 and mask_name == "ragged" and not reverse:
                    main = (xs, dout, gates, hprev, mask)
    xs, dout, gates, hprev, mask = main
    T = xs.shape[1]
    ms = cuda_ms(lambda: gru_sequence_backward(dout, gates, hprev, wh, mask, False))
    plain = cuda_ms(lambda: gru_sequence_backward_plain(dout, gates, hprev, wh, mask, False), 1, 3)
    # Library yardstick: cuDNN's GRU backward (fwd+bwd minus fwd), the same
    # function only when every step is valid (b_hh = 0).
    lib = torch.nn.GRU(D, H, batch_first=True).to(dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(wx.T)
        lib.weight_hh_l0.copy_(wh.T)
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
    xs_g = xs.clone().requires_grad_()

    def fwd_bwd():
        out = lib(xs_g)[0]
        out.backward(dout)

    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: lib(xs))
    lib_ms = cuda_ms(fwd_bwd) - lib_fwd
    n_bytes = nbytes(dout, gates, hprev, wh, mask) + 2 * B * T * 3 * H * 4
    n_ops = 2 * B * T * 3 * H * H
    bms, by = bound_ms(n_bytes, n_ops, "f32")
    return {
        "name": "gru_sequence_backward", "route": "cuda",
        "source": "sstts_torch/csrc/gru.cu",
        "replaces": "sstts/ops/pallas_gru.py:126",
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "shape": [B, T, D, H], "checks": checks,
    }


def check_teacher(dev):
    """B6 against its plain version: f32 at S=20, bf16 at the training
    shape (S=103), and the gradient through its autograd.Function."""
    import torch

    from sstts_torch.config import Config
    from sstts_torch.model.tacotron import Tacotron, init_state_dict
    from sstts_torch.ops import teacher as tops

    cfg = Config()
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=12))
    cell = model.decoder_cell.to(dev)
    B, T, Dm, P1 = 32, 128, 2 * cfg.arch.encoder_gru_units, cfg.arch.prenet_units[-1]
    g = torch.Generator().manual_seed(13)
    memory = (0.5 * torch.randn(B, T, Dm, generator=g)).to(dev)
    lengths = torch.randint(40, T + 1, (B,), generator=g).to(dev)
    maskf = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    with torch.no_grad():
        keys = cell.attention.init_keys(memory)
    w = tops.teacher_weights_from_cell(cell)
    checks, main = [], None
    # (S, dtype, tolerance on xs, on alignments): f32 is the same arithmetic
    # in another summation order (2e-4 / 2e-5, as B4 and the JAX package's
    # tests hold the TPU kernel); bf16 rounds every product's operands, and
    # a different f32 sum can round an activation to the neighbouring bf16
    # value, which the steps carry forward: 5e-2 of the largest value.
    for S, dt in ((20, torch.float32), (103, torch.bfloat16)):
        pre = torch.relu(torch.randn(B, S, P1, generator=g)).to(dev)
        with torch.no_grad():
            got = tops.fused_teacher_scan(w, pre, memory, keys, maskf, dt)
            ref = tops.fused_teacher_scan_plain(w, pre, memory, keys, maskf, dt)
        torch.cuda.synchronize()
        scale = float(ref[0].abs().max())
        tol_x = 2e-4 if dt == torch.float32 else 5e-2 * max(1.0, scale)
        tol_a = 2e-5 if dt == torch.float32 else 5e-2
        errs = {"xs": max_err(got[0], ref[0]), "align": max_err(got[1], ref[1])}
        case = f"S{S}-{str(dt).split('.')[-1]}"
        log(f"  B6 fused_teacher_scan {case}: {errs} (tol xs {tol_x:.3g}, align "
            f"{tol_a}; |xs| max {scale:.3g})")
        if not (errs["xs"] <= tol_x and errs["align"] <= tol_a):
            raise AssertionError(f"fused_teacher_scan {case}: {errs}")
        checks.append({"case": case, "max_abs_err": max(errs.values()), "tol": tol_x,
                       "errors": errs})
        if dt == torch.float32:
            f32_pre = pre
        main = (pre, checks[-1], S)
    # The gradient through the Function (kernel forward, plain f32 recompute
    # backward) against autograd through the plain f32 scan, on the f32
    # case: the same backward arithmetic, so 1e-5 of each leaf's largest.
    params = [p for p in cell.parameters()]

    def grads(fn):
        for p in params:
            p.grad = None
        xs, al = fn(tops.teacher_weights_from_cell(cell), f32_pre, memory, keys, maskf,
                    torch.float32)
        (xs.square().mean() + al.square().mean()).backward()
        return [p.grad.clone() if p.grad is not None else None for p in params]

    got_g = grads(tops.fused_teacher_scan_ad)
    ref_g = grads(tops.fused_teacher_scan_plain)
    rel = max(
        max_err(a, r) / max(float(r.abs().max()), 1e-30)
        for a, r in zip(got_g, ref_g) if r is not None
    )
    n_leaves = sum(r is not None for r in ref_g)
    log(f"  B6 gradient through the autograd.Function (S=20, f32, {n_leaves} leaves): "
        f"relative error {rel:.3e} (tol 1e-5)")
    if not (rel <= 1e-5 and n_leaves == len(tops.TeacherWeights._fields)):
        raise AssertionError(f"fused_teacher_scan gradient: {rel}, {n_leaves} leaves")
    checks.append({"case": "grad-S20-float32", "rel_err": rel, "tol": 1e-5})
    pre, main_check, S = main
    # Timed on inputs already in the kernel's types, as B4 is.
    bf = torch.bfloat16
    wc = tops.TeacherWeights(*[t.detach().contiguous() for t in tops._cast(w, bf)])
    mem_b, keys_b = memory.to(bf), keys.to(bf)
    with torch.no_grad():
        ms = cuda_ms(lambda: tops.fused_teacher_scan(wc, pre, mem_b, keys_b, maskf, bf), 3, 5)
        plain = cuda_ms(lambda: tops.fused_teacher_scan_plain(
            wc, pre, mem_b, keys_b, maskf, bf), 1, 3)
    n_bytes = nbytes(*wc, pre, mem_b, keys_b, maskf) + 4 * B * S * (
        cfg.arch.decoder_gru_units + T)
    macs = sum(t.numel() for t in w if t.dim() == 2) + T * (keys.shape[-1] + Dm)
    n_ops = 2 * S * B * macs
    bms, by = bound_ms(n_bytes, n_ops, "bf16")
    return {
        "name": "fused_teacher_scan", "route": "cuda",
        "source": "sstts_torch/csrc/teacher.cu",
        "replaces": "sstts/ops/pallas_decoder.py:447",
        "max_abs_err": main_check["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "shape": [B, T, S], "checks": checks,
    }


def check_decoder(dev):
    import torch

    from sstts_torch.config import Config
    from sstts_torch.model.tacotron import Tacotron, init_state_dict
    from sstts_torch.ops import decoder as dec

    cfg = Config()
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=2))
    cell = model.decoder_cell.to(dev).eval()
    B, T, Dm = 32, 96, 2 * cfg.arch.encoder_gru_units
    g = torch.Generator().manual_seed(3)
    memory = (0.5 * torch.randn(B, T, Dm, generator=g)).to(dev)
    lengths = torch.randint(40, T + 1, (B,), generator=g).to(dev)
    mask = torch.arange(T, device=dev)[None] < lengths[:, None]
    gdev = torch.Generator(device=dev).manual_seed(4)
    checks, main = [], None
    # (S, dtype, stop threshold, tolerance on mel/stop, on alignments):
    # f32 is the same arithmetic in another summation order (2e-4 / 2e-5,
    # as tests/test_pallas_decoder.py holds the JAX kernel); bf16 rounds
    # every product's operands, and a different f32 sum can round an
    # activation to the neighbouring bf16 value, which 160 autoregressive
    # steps carry forward: held loosely, 5e-2 of the largest value.
    for S, dt, thr in ((20, torch.float32, 0.5), (160, torch.bfloat16, 1.1)):
        keep = dec.draw_keep_masks(S, B, cfg.arch.prenet_units, 0.5, gdev, dev)
        with torch.no_grad():
            p = dec.prepare_decode(
                cell, memory, mask, S, stop_threshold=thr, min_steps=8,
                keep=keep, matmul_dtype=dt,
            )
            got = dec.decode_steps(p)
            ref = dec.decode_steps_plain(p)
        torch.cuda.synchronize()
        scale = float(ref["mel"].abs().max())
        tol_mel = 2e-4 if dt == torch.float32 else 5e-2 * max(1.0, scale)
        tol_al = 2e-5 if dt == torch.float32 else 5e-2
        errs = {k: max_err(got[k], ref[k]) for k in ("mel", "stop", "align")}
        fin_equal = bool(torch.equal(got["fin"], ref["fin"]))
        case = f"S{S}-{str(dt).split('.')[-1]}"
        log(f"  B4 fused_decode {case}: {errs} fin_equal={fin_equal} "
            f"(tol mel/stop {tol_mel:.3g}, align {tol_al}; |mel| max {scale:.3g})")
        if not (fin_equal and errs["mel"] <= tol_mel and errs["stop"] <= tol_mel
                and errs["align"] <= tol_al):
            raise AssertionError(f"fused_decode {case}: {errs}, fin {fin_equal}")
        checks.append({"case": case, "max_abs_err": max(errs.values()),
                       "tol": tol_mel, "errors": errs})
        main = (p, checks[-1])
    p, main_check = main
    with torch.no_grad():
        ms = cuda_ms(lambda: dec.decode_steps(p), 3, 5)
        plain = cuda_ms(lambda: dec.decode_steps_plain(p), 1, 3)
    w = p.w
    S, r, M = p.max_steps, p.reduction, p.n_mels
    A = p.keys.shape[-1]
    n_bytes = nbytes(*w, p.memory, p.keys, p.maskf, p.keep0, p.keep1) + 4 * B * S * (
        r * M + r + T + 1
    )
    macs = sum(getattr(w, n).numel() for n in dec._MATRICES) + T * (A + Dm)
    n_ops = 2 * S * B * macs
    bms, by = bound_ms(n_bytes, n_ops, "bf16")
    return {
        "name": "fused_decode", "route": "cuda",
        "source": "sstts_torch/csrc/decoder.cu",
        "replaces": "sstts/ops/pallas_decoder.py:169",
        "max_abs_err": main_check["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "shape": [B, T, S], "checks": checks,
    }


def check_gl(dev):
    import torch

    from sstts_torch.config import Config
    from sstts_torch.dsp.gl_fused import reproject_analyze, reproject_analyze_plain
    from sstts_torch.dsp.reproject import band_plan, padded_wss2d

    ds = Config().dataset
    Bt, T = 32, 800
    length = (T - 1) * ds.hop_len
    plan = band_plan(ds.n_fft, ds.hop_len, ds.win_len, T, length)
    w_len, d_max = plan["w_len"], plan["d_max"]
    wp, hp = 1152, 1024
    g = torch.Generator().manual_seed(5)
    frames = torch.randn(Bt, T, wp, generator=g)
    frames[..., w_len:] = 0.0  # GEMM1's zero lanes
    frames = frames.to(dev, torch.bfloat16)
    mag2 = torch.rand(Bt, T, 2 * hp, generator=g).to(dev, torch.bfloat16)
    w_fwd = (torch.randn(wp, 2 * hp, generator=g) / 32).to(dev, torch.bfloat16)
    prev = torch.randn(Bt, T, 2 * hp, generator=g).to(dev, torch.bfloat16)
    wss2d = padded_wss2d(plan, wp, dev)
    args = (frames, mag2, w_fwd, wss2d, w_len, ds.hop_len, d_max)
    checks = []
    # bf16 out: the kernel and the plain version round at the same points
    # and differ only in f32 summation order, which flips an output's last
    # bf16 bit now and then: one bf16 step at |q| <= 1 (2^-7) absolute, and
    # under 1% of the elements may differ at all.
    tol = 2.0**-7
    for m in (0.0, 0.99):
        pv = prev if m else None
        got = reproject_analyze(*args, pv, m)
        ref = reproject_analyze_plain(*args, pv, m)
        torch.cuda.synchronize()
        for name, a, b in (("q", got[0], ref[0]), ("s", got[1], ref[1])):
            if a is None:
                continue
            err = max_err(a, b)
            frac = float((a != b).float().mean())
            scale = float(b.float().abs().max())
            case = f"{'momentum' if m else 'classic'}-{name}"
            # s is the raw spectrum (|s| up to `scale`): the same one-step
            # rule relative to its size.
            t = tol * max(1.0, scale)
            log(f"  B2 fused_reproject_analyze {case}: max_abs_err {err:.3e} "
                f"differing {frac:.2e} (tol {t:.3g}, < 1%)")
            if not (err <= t and frac < 1e-2):
                raise AssertionError(f"fused_reproject_analyze {case}: {err}, {frac}")
            checks.append({"case": case, "max_abs_err": err, "tol": t,
                           "differing": frac})
    ms = cuda_ms(lambda: reproject_analyze(*args, None, 0.0))
    plain = cuda_ms(lambda: reproject_analyze_plain(*args, None, 0.0), 2, 3)
    ms_m = cuda_ms(lambda: reproject_analyze(*args, prev, 0.99))
    n_bytes = nbytes(frames, mag2, w_fwd, wss2d) + Bt * T * 2 * hp * 2
    n_ops = 2 * Bt * T * wp * 2 * hp
    bms, by = bound_ms(n_bytes, n_ops, "bf16")
    return {
        "name": "fused_reproject_analyze", "route": "cuda",
        "source": "sstts_torch/csrc/gl_semi.cu",
        "replaces": "sstts/dsp/gl_fused.py:227",
        "max_abs_err": checks[0]["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "ms_momentum": ms_m, "shape": [Bt, T, wp, 2 * hp],
        "checks": checks,
    }


def pending_bounds():
    """The bounds of the TPU kernels still to port, at the synthesis path's
    size (b=32 x 800 frames, packed width 1152, 2 x 1024 bins), by the rule
    of the ported ones."""
    rows, wp, hp = 32 * 800, 1152, 1024
    # B1: out = wss2d * (9 shifted frames summed), bf16 frames in and out.
    b1 = bound_ms(2 * rows * wp * 2, 10 * rows * wp, "f32")
    # B5: B2 with GEMM1 inside: q (bf16) -> frames -> spectrum, two GEMMs;
    # q and mag2 in, q out, w_inv and w_fwd once.
    b5 = bound_ms(3 * rows * 2 * hp * 2 + 2 * wp * 2 * hp * 2, 2 * 2 * rows * wp * 2 * hp, "bf16")
    return [
        {"name": "reproject_frames_pallas", "replaces": "sstts/dsp/reproject.py:207",
         "bound_ms": b1[0], "bound_by": b1[1]},
        {"name": "fused_gl_iteration", "replaces": "sstts/dsp/gl_fused.py:491",
         "bound_ms": b5[0], "bound_by": b5[1]},
    ]


# ---------------------------------------------------------------- phase 3 --


def reset():
    """Set every kernel wrapper's launch count to 0."""
    from sstts_torch.ops import kernel_wrappers

    for w in kernel_wrappers().values():
        w.launches = 0


def counts():
    from sstts_torch.ops import kernel_wrappers

    return {k: w.launches for k, w in kernel_wrappers().items()}


def main_path(dev, card):
    import numpy as np
    import torch

    from sstts_torch.config import Config, tiny_config, with_fast_vocoder
    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.synthesize import Synthesizer

    cfg = Config()
    cfg = cfg.replace(
        inference=dataclasses.replace(
            cfg.inference, max_decoder_steps=160, stop_threshold=1.1,
            griffin_lim_iters=60,
        )
    )
    texts = ["the quick brown fox jumps over the lazy dog " * 2] * 32
    t0 = time.perf_counter()
    params = init_state_dict(cfg.arch, cfg.dataset, seed=0)
    synth = Synthesizer(cfg, params, seed=0)
    log(f"  init + Synthesizer: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    synth.synthesize_batch(texts)
    torch.cuda.synchronize()
    log(f"  warm-up batch: {time.perf_counter() - t0:.3f} s")

    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wavs = synth.synthesize_batch(texts)
    wall = time.perf_counter() - t0
    launches = counts()
    expected = {"gru_sequence": 4, "gru_sequence_backward": 0, "fused_teacher_scan": 0,
                "fused_decode": 1, "fused_reproject_analyze": 60}
    log(f"  main path launches: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    n_expected = min(800 * cfg.dataset.hop_len, 799 * cfg.dataset.hop_len)
    for w in wavs:
        if w.shape != (n_expected,) or not np.isfinite(w).all():
            raise AssertionError(f"waveform shape {w.shape} / finite {np.isfinite(w).all()}")
    audio_s = len(wavs) * n_expected / cfg.dataset.sample_rate
    log(f"  main path: b=32, 800 frames, GL-60, PCM16: wall {wall:.4f} s, "
        f"{audio_s:.2f} s of audio, {audio_s / wall:.2f} s audio / wall s "
        f"[{card}]")
    result = {"wall_s": wall, "audio_s": audio_s, "rtf_x": audio_s / wall,
              "launches": launches}

    # The same pipeline on a tiny config: the card (kernels) against the
    # CPU (their plain versions), deterministic (dropout off), both with
    # the fused decoder's bf16 products and the bf16 Griffin-Lim loop.
    tcfg = tiny_config()
    tcfg = tcfg.replace(
        arch=dataclasses.replace(tcfg.arch, prenet_dropout_at_inference=False),
        inference=dataclasses.replace(
            tcfg.inference, decoder_impl="fused", stop_threshold=1.1,
            max_decoder_steps=24, griffin_lim_iters=8,
        ),
    )
    tparams = init_state_dict(tcfg.arch, tcfg.dataset, seed=1)
    small = ["the quick brown fox", "jumps over the lazy dog twice"]
    _, on_card = Synthesizer(tcfg, tparams).synthesize_batch(small, full_output=True)
    _, on_cpu = Synthesizer(tcfg, tparams, device="cpu").synthesize_batch(
        small, full_output=True
    )
    rel = float(np.linalg.norm(on_card["wav"] - on_cpu["wav"])
                / np.linalg.norm(on_cpu["wav"]))
    mel_err = float(np.abs(on_card["mel"] - on_cpu["mel"]).max())
    log(f"  tiny config card vs CPU plain: n_frames {on_card['n_frames'].tolist()} "
        f"vs {on_cpu['n_frames'].tolist()}, mel max_abs_err {mel_err:.3e}, "
        f"wav rel L2 {rel:.3e} (tol 5e-2: bf16 loops)")
    if not (np.array_equal(on_card["n_samples"], on_cpu["n_samples"]) and rel < 5e-2):
        raise AssertionError(f"tiny card vs CPU: rel {rel}")
    result["tiny_card_vs_cpu_rel_l2"] = rel

    fast = Synthesizer(with_fast_vocoder(cfg), params, seed=0)
    fast.synthesize_batch(texts)  # warm-up
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwavs = fast.synthesize_batch(texts)
    fwall = time.perf_counter() - t0
    flaunch = counts()
    log(f"  fast vocoder (GL-30 @ m=0.99): wall {fwall:.4f} s, "
        f"{audio_s / fwall:.2f} s audio / wall s, launches {flaunch} [{card}]")
    if flaunch["fused_reproject_analyze"] != 30 or not all(
        np.isfinite(w).all() for w in fwavs
    ):
        raise AssertionError(f"fast vocoder launches {flaunch}")
    result.update({"fast_wall_s": fwall, "fast_rtf_x": audio_s / fwall})
    result["profile"] = profile(lambda: synth.synthesize_batch(texts), card)
    return result


def profile(fn, card, host_ops=()) -> dict:
    """Device time by kernel over one call of `fn` (torch.profiler), the
    device's busy share of its wall time, and the host time spent inside
    the CPU-side ops named in `host_ops`."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # Device-side events only (kernels, memcpys): a CPU op's row would count
    # the kernels it launched a second time.
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    rows = {}
    for e in device:
        us, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:  # union of the device intervals
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    span_us = max(e for _, e in spans) - spans[0][0]
    log(f"  profile: wall {wall * 1e3:.2f} ms; device span {span_us / 1e3:.2f} ms, "
        f"busy {busy_us / 1e3:.2f} ms ({busy_us / 1e3 / (wall * 1e3):.1%} of wall), "
        f"idle inside the span {(span_us - busy_us) / 1e3:.2f} ms, host-only time "
        f"outside it {wall * 1e3 - span_us / 1e3:.2f} ms [{card}]")
    for name, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {us / 1e3:9.3f} ms  x{n:<5d} {name[:90]}")
    host = {}
    for e in prof.events():
        for op in host_ops:
            if e.device_type == DeviceType.CPU and e.name == op:
                host[op] = host.get(op, 0.0) + e.time_range.elapsed_us() / 1e3
    for op, ms in host.items():
        log(f"    host {ms:9.3f} ms inside {op}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_us / 1e3, "span_ms": span_us / 1e3,
            "host_ms": host}


# --------------------------------------------------------------- phase 3b --


def fixed_batch(cfg, n: int, bucket: int, words):
    """A batch of `n` synthetic utterances of `words` (min, max) words that
    all land in `bucket` (the smallest bucket each fits)."""
    from sstts_torch.data import pipeline
    from sstts_torch.data.synthetic import make_utterances

    shapes = pipeline.frame_bucket_shapes(cfg)
    hop = cfg.dataset.hop_len
    batcher = pipeline.Batcher(make_utterances(8 * n, cfg.dataset, *words), cfg)
    items = []
    for u, ids in batcher.examples:
        audio = batcher.audio(u)
        if pipeline.assign_bucket(len(ids), 1 + len(audio) // hop, shapes) == bucket:
            items.append((ids, audio))
        if len(items) == n:
            break
    if len(items) < n:
        raise AssertionError(f"only {len(items)} utterances land in bucket {bucket}")
    lt, fr = shapes[bucket]
    return pipeline.make_batch(items, lt, fr, cfg)


def train_path(dev, card):
    """The training path at full width, its counts, losses and time."""
    import shutil

    import numpy as np
    import torch

    from sstts_torch import train as tr
    from sstts_torch.checkpoint import CheckpointManager
    from sstts_torch.config import Config, tiny_config
    from sstts_torch.synthesize import Synthesizer

    cfg = Config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, dataset="synthetic"),
        training=dataclasses.replace(cfg.training, batch_size=32),
    )
    batch = fixed_batch(cfg, 32, 1, (10, 16))
    B, L = batch["char_ids"].shape
    F = (batch["samples"].shape[1] // cfg.dataset.hop_len) + 1
    log(f"  batch: b={B}, text {L}, {F} frames ({F // cfg.arch.reduction_factor} "
        f"decoder steps); mean valid frames {batch['n_frames'].mean():.1f}, mean text "
        f"{batch['text_len'].mean():.1f}")
    t0 = time.perf_counter()
    state = tr.create_state(cfg, seed=0)
    step = tr.make_train_step(cfg)
    log(f"  create_state: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    log(f"  warm-up step: {time.perf_counter() - t0:.3f} s")

    reset()
    torch.cuda.synchronize()
    losses, times = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = counts()
    expected = {"gru_sequence": 20, "gru_sequence_backward": 20, "fused_teacher_scan": 5,
                "fused_decode": 0, "fused_reproject_analyze": 0}
    log(f"  5 train steps: launches {launches} (expected {expected}: 4/4/1 a step)")
    if launches != expected:
        raise AssertionError(f"train launch counts {launches} != {expected}")
    ms = [t * 1e3 for t in times]
    log(f"  losses {losses}; ms per step {ms} (median {statistics.median(ms):.2f}) "
        f"[{card}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[4] < losses[0]:
        raise AssertionError(f"the loss did not fall over 5 steps: {losses}")
    result = {"losses": losses, "ms_per_step": ms, "median_ms": statistics.median(ms),
              "launches": launches, "grad_norm": float(m["grad_norm"])}
    result["profile"] = profile(lambda: step(state, batch), card, (
        "autograd::engine::evaluate_function: _FusedTeacherScanBackward",
        "autograd::engine::evaluate_function: _GRUSequenceBackward",
        "Optimizer.step#Adam.step",
    ))

    reset()
    emetrics, out = tr.make_eval_step(cfg)(state, batch)
    torch.cuda.synchronize()
    elaunch = counts()
    expected = {"gru_sequence": 4, "gru_sequence_backward": 0, "fused_teacher_scan": 1,
                "fused_decode": 0, "fused_reproject_analyze": 0}
    eloss = float(emetrics["loss"])
    log(f"  eval step: loss {eloss:.5f}, launches {elaunch} (expected {expected})")
    if elaunch != expected or not np.isfinite(eloss):
        raise AssertionError(f"eval step: {elaunch}, loss {eloss}")
    result["eval_loss"] = eloss

    workdir = Path(__file__).resolve().parent / "chip_scratch" / "train_ckpt"
    shutil.rmtree(workdir, ignore_errors=True)
    CheckpointManager(cfg, workdir).save(state.step, state)
    synth = Synthesizer.from_checkpoint(workdir)
    wavs = synth.synthesize_batch(["the quick brown fox", "speech from a checkpoint"])
    shutil.rmtree(workdir)
    log(f"  from_checkpoint: step {state.step}, 2 utterances of "
        f"{[len(w) for w in wavs]} samples")
    if not all(len(w) > 0 and np.isfinite(w).all() for w in wavs):
        raise AssertionError("synthesis from the checkpoint failed")

    # One tiny train step: the card (kernels, f32 teacher products) against
    # the CPU (plain versions, the fused scan's plain version), dropout off.
    # Both are f32 throughout (TF32 off), with sums in other orders: 1e-4.
    tcfg = tiny_config()
    tcfg = tcfg.replace(
        dataset=dataclasses.replace(tcfg.dataset, dataset="synthetic"),
        arch=dataclasses.replace(tcfg.arch, prenet_dropout=0.0),
        training=dataclasses.replace(tcfg.training, text_buckets=(48,), frame_buckets=(96,)),
    )
    tbatch = fixed_batch(tcfg, 2, 0, (1, 2))
    tstep = tr.make_train_step(tcfg)
    res = {}
    for name, device in (("card", None), ("cpu", "cpu")):
        st = tr.create_state(tcfg, seed=1, device=device)
        st.model.teacher_impl, st.model.teacher_dtype = "fused", torch.float32
        res[name] = {k: float(v) for k, v in tstep(st, tbatch).items()}
    rel = {k: abs(res["card"][k] - res["cpu"][k]) / abs(res["cpu"][k])
           for k in ("loss", "grad_norm")}
    log(f"  tiny train step, card vs CPU: {res['card']} vs {res['cpu']}; relative "
        f"differences {rel} (tol 1e-4)")
    if not max(rel.values()) <= 1e-4:
        raise AssertionError(f"tiny train step card vs CPU: {rel}")
    result["tiny_card_vs_cpu_rel"] = rel
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    from sstts_torch.ops import build
    from sstts_torch.synthesize import exact_f32

    dev = torch.device("cuda")
    card = card_line()
    log(f"phase 0: card: {card}")
    nvcc_v = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                            text=True, timeout=60).stdout.strip().splitlines()[-1]
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc_v}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"phase 1: built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    log("phase 2: kernels against their plain versions")
    with exact_f32(dev):
        kernels = [
            check_gru(dev), check_gru_backward(dev), check_teacher(dev),
            check_decoder(dev), check_gl(dev),
        ]
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}) [{card}]")
    pending = pending_bounds()
    for k in pending:
        log(f"  still to port, {k['name']}: bound {k['bound_ms']:.4f} ms by {k['bound_by']}")

    log("phase 3: the synthesis path")
    main_res = main_path(dev, card)
    log("phase 3b: the training path")
    train_res = train_path(dev, card)
    training = ("gru_sequence_backward", "fused_teacher_scan")
    for k in kernels:
        by_path = {"synthesis": main_res["launches"][k["name"]],
                   "training": train_res["launches"][k["name"]]}
        k["launches"] = by_path["training" if k["name"] in training else "synthesis"]
        k["launches_by_path"] = by_path
    log(json.dumps({"main_path": main_res, "train_path": train_res,
                    "pending_bounds": pending, "card": card}))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
