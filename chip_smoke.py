#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`sstts_torch`) on one NVIDIA card.

    python3 chip_smoke.py     # needs one CUDA card

Phases, in order; any failure is an uncaught exception and a non-zero exit:

0. the card's name and power limit (nvidia-smi), torch/CUDA/nvcc versions;
1. build every kernel from `sstts_torch/csrc/` (one nvcc per source, all
   started together) into the git-ignored `sstts_torch/_build/`;
2. each kernel against its plain PyTorch version, on the card, at the main
   path's shapes, with the tolerance stated beside each check; median times
   from CUDA events for the kernel, its plain version and, where one
   PyTorch call computes the same function, that call;
3. the main path: `Synthesizer.synthesize_batch` at the full default
   `Config()` from a seeded random init, bench.py's workload (32 x an 88
   character text, 160 decoder steps = 800 frames, stop threshold 1.1,
   classic Griffin-Lim-60, PCM16): one warm-up batch, then one timed batch
   with every launch counter set to 0 just before and read just after
   (4 GRU, 1 decode, 60 Griffin-Lim launches); then the same text on a
   tiny config on the card against the plain versions on the CPU; one
   batch with the fast vocoder (GL-30 at momentum 0.99), which runs the
   Griffin-Lim kernel's momentum variant; and one main-path batch under
   torch.profiler for the device time by kernel and the busy share;
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


# ---------------------------------------------------------------- phase 3 --


def main_path(dev, card):
    import numpy as np
    import torch

    from sstts_torch.config import Config, tiny_config, with_fast_vocoder
    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.ops import kernel_wrappers
    from sstts_torch.synthesize import Synthesizer

    wrappers = kernel_wrappers()

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

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
    expected = {"gru_sequence": 4, "fused_decode": 1, "fused_reproject_analyze": 60}
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
    profile_batch(synth, texts, card)
    return result


def profile_batch(synth, texts, card) -> None:
    """Device time by kernel over one main-path batch (torch.profiler), and
    the device's busy share of the batch's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.synthesize_batch(texts)
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
        kernels = [check_gru(dev), check_decoder(dev), check_gl(dev)]
    for k in kernels:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}) [{card}]")

    log("phase 3: main path")
    main_res = main_path(dev, card)
    for k in kernels:
        k["launches"] = main_res["launches"][k["name"]]
    log(json.dumps({"main_path": main_res, "card": card}))
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
