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
   PyTorch call computes the same function, that call; and each kernel's
   bound, from its shapes; for the GRU kernels also what ptxas reported
   (registers, no spill in the H = 128 kernels), all four kinds of kernel
   (H = 128, the generic one at H = 16, the wide one, a cluster a tile of
   the batch, the batch in one wave, at H = 138, 256 and 512 at full size,
   B = 32, T = 800 forward and 515 backward, and at 139, 301, 256 and 512
   at B = 1, 3, 4 and 33 (tiles not full), T = 1 and 37; the grid
   one, a cooperative grid a direction whose blocks each own U units of
   every sequence, at H = 560, 752 and 1104 with D = 128 at full size and
   at one step, an odd length at B = 1, 3 and 33, 561 and 1103 (a last
   block owning fewer units) and 1025, and past H = 1419, where its blocks
   stream the part of their slice of Wh that their shared memory cannot
   hold, at 1420, 2048 and 5456 (the widest taken) at full size and at
   2048, 2113 (a last block owning fewer units, two gate items a thread)
   and 5456 beside; two launches of each bit-equal, each main width beside
   cuDNN's nn.GRU at the same H, timed in turns with it, its bound with
   both terms (f32 operations, and the bytes of Wh that shared memory and
   L2 cannot keep, read once a step); the wrapper's count of the wide and
   grid kinds' shared memory (the wide kind's tile rows and threads, the
   grid's resident K range and scratch) held to the library's at every H
   past 137, the clusters of each size the card holds to the wrapper's
   table and B = 32 to one wave at every wide H, the grid's blocks held to
   how many the card holds at once, and the blocks, cluster size and streamed
   columns of each width on a line of its own), and their stages' times
   apart;
   every decode case (B4) with the prenet dropout on, drawn in the kernel
   from a seed and held to the plain version's draw of the same bits;
   for the decode kernel B4 also the tiny config's widths (at a dropout
   rate of 0.5 and of 0.25), B=3 at T=300,
   rows that stop at different steps, T=4096, and the longest T taken and
   the next refused before any launch, and phase 3i's cell (products of
   1536 columns, two panels) at (32, 96, 160) in bf16 and f32 (f32 also at
   20 steps) and a cell of three panels a product or more (A = 2560, Dm =
   2176) at B = 2; for the teacher-forced scan B6 also phase 3i's cell at
   (32, 128, 103) in bf16 and f32 and the three-panel cell, and
   one utterance, an odd T, its longest T and the next refused, the
   gradient, and the launch's host time with the card busy; for B1 bit
   equality at the split iteration's shapes and at batches of 1 and 3, 515,
   37 and 5 frames, hops of 137 and 110 samples (D = 8, 10), a 16 kHz
   geometry and 44.1 kHz at a 128-sample hop (D = 15: in f32 the direct
   configuration), in bf16 and f32, one CUDA kernel a call (its mirror runs
   inside), no spill; for the two Griffin-Lim GEMM kernels also batches of
   3, 2 and 1 utterances (clusters of two with a member left over) and 515,
   37 and 5 frames, other geometries in bf16 and f32 (a hop of 137 samples,
   D = 8, for B2; 16 kHz, 24 kHz, hops of 10, 5 and 3 ms and 44.1 kHz at
   n_fft 2048 for both; the f32 loop at the defaults too: the wide
   configuration, f32 held to 1e-5 relative L2), NotImplementedError and
   no launch beyond n_fft 2048 or 16 overlapping frames a side, each
   geometry's launch at 32 x 800 in each loop dtype held to the plain
   version again (a persistent wide block walks more than one item there)
   and timed, with its bound, the f32 "split" iteration's time, the
   momentum variant's time,
   the host's time per launch and ptxas's registers (no spill in the
   whole-panel kernels);
3. the synthesis path: `Synthesizer.synthesize_batch` at the full default
   `Config()` from a seeded random init, bench.py's workload (32 x an 88
   character text, 160 decoder steps = 800 frames, stop threshold 1.1,
   classic Griffin-Lim-60, PCM16): one warm-up batch, then one timed batch
   with every launch counter set to 0 just before and read just after
   (4 GRU, 1 decode, 60 Griffin-Lim launches) and the decode's route
   "fused" for its text width (`Synthesizer.decode_routes`); then the same
   text on a
   tiny config on the card against the plain versions on the CPU; one
   batch with the fast vocoder (GL-30 at momentum 0.99), which runs the
   Griffin-Lim kernel's momentum variant; and one main-path batch under
   torch.profiler for the device time by kernel and the busy share;
3c. the serving path, bench.py's candidates on the same workload: fused-60,
   split-60 and semi-25@0.99 with PCM16 or the adpcm3/adpcm4/mulaw8 wires,
   each one warm-up batch and then `synthesize_stream` over 4 batches at
   depth 2 with the counters set to 0 just before and read just after
   (B5 or B1 or B2 once an iteration, 4 GRU and 1 decode a batch); the
   wire encoders on the card against the CPU (equal bytes), a stream yield
   against `synthesize_batch`, the tiny config card against CPU for split
   (bf16 and f32 loops) and fused, the f32 Griffin-Lim loop card against
   CPU through "split" (B1), "semi" (B2) and "fused" (B5), a 3-sentence
   long-form paragraph and `to_file`;
3b. the training path at the full default `Config()` on the synthetic
   corpus: b=32 in the (128 characters, 515 frames) bucket, 103 decoder
   steps; one warm-up train step, then 5 timed steps on one fixed batch
   with the counters set to 0 just before and read just after (4 GRU
   forward, 4 GRU backward, 1 teacher scan per step); the loss finite at
   every step and lower at the 5th than at the 1st; one profiled step; one
   eval step (4/0/1); a checkpoint, `Synthesizer.from_checkpoint` and two
   utterances from it; and a tiny config's train step on the card (kernels,
   f32 teacher products) against the same step on the CPU (plain versions);
3d. the command line (`sstts_torch.cli.main`, on the card) at the default
   `Config()` widths: an LJSpeech-layout corpus of 96 synthetic utterances
   (22,050 Hz PCM16, 0.25 s of silence at each end) and a CSS10-layout one
   of 8 at 16 kHz written to disk; `precompute --features --stats`, `train
   --max-steps 2` from that cache (b=32), `evaluate --num-batches 1
   --synthesize 2`, `synthesize` with `--text`, `--text-file` (3 lines) and
   `--longform`, and `train --max-steps 1` on the CSS10 corpus resampled on
   load; each command's wall time and launches, with the counters set to 0
   just before and read just after it and held to the counts its corpus
   implies (a train step 4/4/1, an eval batch 4 GRU and 1 teacher scan, a
   synthesis batch 4 GRU, 1 decode and griffin_lim_iters B2 launches, and
   the train media's Griffin-Lim where matplotlib imports); the WAV files,
   the `metrics.jsonl` records in the JAX package's shape, finite eval
   losses and resynthesis mel-L1, and the cache's index;
3e. the resident corpus (`train.build_device_corpus`) at the default
   `Config()` widths, b=32, on the synthetic corpus (256 utterances, 5%
   held out, buckets 0 and 1): built in each format (pcm16, features,
   features_bf16) with its bytes, build time and peak memory; one step on
   32 rows of bucket 1 from one init in each mode, held to the host-fed
   step (cached pcm16, loss and grad_norm within 1e-5 relative) and to the
   pcm16 step (features 1e-4, features_bf16 1e-2); a grouped S=4 call
   against four cached steps, and four cached steps run twice, bit-equal
   under PyTorch's deterministic algorithms (cuDNN's convolution backward
   and nn.Embedding's above 3072 indices add by atomics); the direct-DFT
   features against torch.fft's (dft_highest 1e-4, dft_high 1e-3,
   dft_default 2e-2 on 99% of the normalized values, the largest and the
   mean printed: low-energy bins amplify rounding, even in f32, and one
   bf16 pass, the reference's own DEFAULT rung, reaches ~6e-2 at its worst
   value);
   the prefetch's batches against the `Batcher`'s; medians of 8 host-fed
   (through the prefetch), 8 cached and 8 grouped calls on the same rows,
   in turns, and one profiled cached step; `train` at "auto" (8 steps), at
   steps_per_call=4 (8) and "off" (4), each with the counters set to 0
   just before and read just after (a step 4/4/1, the eval as
   `cli_expected` counts it); "on" over a 1 MiB budget must raise
   ValueError and a NaN planted in the embedding under debug_nans
   FloatingPointError. Every step above launches B3 4, B3' 4, B6 1;
3f. the architecture variants at the default `Config()` widths, each run
   with the counters set to 0 just before and read just after:
   `compute_dtype="bfloat16"` synthesis on bench.py's workload (warm-up,
   one timed batch: B3 4, B4 1, B2 60), its teacher-forced forward and 8
   decode steps (B4) against the f32 model's on the same weights (relative
   L2 under 2e-2), B4 (8 steps) and B6 (103 teacher-forced steps) against
   the same bf16 model's plain loops at the same dropout seed
   (`BF16_LOOP_TOL`), 5 bf16 train steps on phase 3b's bucket (4/4/1 a
   step, the loss falling), the first step's gradient against the f32
   step's (cosine at least 0.999) and the tiny bf16 step card vs CPU
   (2e-2);
   local-Luong attention, whose decoder and teacher scan run the plain
   loops on the card as the reference's "auto" runs its scans (synthesis:
   B3 4, B2 60, B4 0; 2 train steps: B3 4, B3' 4, B6 0 a step), its
   alignment rows summing to 1, the tiny Luong batch and train step card
   vs CPU; the fused conv bank against the unfused bank on the same
   parameters (1e-4, TF32 off) and 2 train steps (4/4/1); and the
   reference's "xla" names on the card at the default architecture:
   `decoder_impl="xla"` synthesis (B4 0), the plain decode loop against B4
   (f32 products, 20 steps: 2e-4 / 2e-5; bf16, the first 8 steps: phase
   2's bf16 limits), the plain teacher-forced loop against B6 (f32 and
   bf16, all 103 steps, the same limits), and 2 train steps with the
   teacher "xla" (B6 0);
3g. the mesh over the G = `torch.cuda.device_count()` cards, the matmul
   FFT and the native decoder: `Synthesizer(mesh=G cards)` on bench.py's
   batch in both partitions against one device ("gspmd" bit-equal at
   G = 1), each shard's launches (B3 4, B4 1, B2 60); 4 train steps on
   phase 3b's batch at lr 2e-4 under deterministic algorithms, one device
   in this process against (G, 1) over NCCL (`mesh.launch`, a process a
   card; (2, 1) and (1, 2) too where G >= 2; at G = 1 it says that tensor
   parallelism was not run), each rank's launches 4/4/1 a step; the matmul
   FFT at (25600, 2048) f32 against torch.fft with the caller's TF32 on;
   GL-60 on it against torch.fft's loop; the native WAV decoder, trimmer
   and ADPCM rows against numpy;
3h. the Griffin-Lim geometries of the GEMM kernels' wide configuration:
   bench.py's batch through `Synthesizer` at the default iteration at 24
   kHz (50 / 12.5 ms), at 44.1 kHz with n_fft 2048 (a 2048-sample window, a
   512-sample hop) and in the f32 loop (`griffin_lim_fft_impl=
   "dft_highest"`), each a warm-up and a timed batch with the counters set
   to 0 just before and read just after (B3 4, B4 1, B2 60) and its audio
   held to the same batch through "split" on the card (STFT magnitudes,
   `GEOMETRY_MAG_TOL`, below a control run that must read above it), one
   recorded B2 launch of the path held to its plain version; and fused-60
   at 24 kHz through `synthesize_stream` (2 batches, B5 60 a batch), then
   held likewise; and B2 on speech-like spectra (the synthetic corpus's
   at 44.1 kHz, semi-60 at momentum 0.99), every launch held to exact sums;
3i. the recurrent widths doubled (`WIDE_ARCH`: BiGRUs of 256 a direction,
   attention and decoder GRUs of 512, products of 1536 columns): bench.py's
   batch through `Synthesizer` (a warm-up and a timed batch, B3 4 on the
   wide kind, B4 1 in column panels, B2 60), its decode against the plain
   loop on the same weights with phase 3f's limits, and 3 train steps on
   phase 3b's bucket (4/4/1 a step, the loss falling), the first step's
   gradient against the teacher "xla" step's (cosine at least 0.999);
3j. the same as 3i on `GRID_ARCH` (the default Config() with BiGRUs of 752
   a direction, the reference GRU kernel's reach at D = 128 on 16 MiB of
   VMEM: B3 and B3' on the grid kind, B4 and B6 on a memory of 1504
   columns);
3k. the same as 3i on `STREAM_ARCH` (the default Config() with BiGRUs of
   1420 a direction, the first width whose grid blocks stream part of
   their slice of Wh: B3 and B3' on the grid kind, the backward streaming,
   B4 and B6 on a memory of 2840 columns);
3l. the per-shape gates at the default `Config()` widths, B = 1, 4
   decoder steps: synthesis at a text width one past B4's reach (the
   library's count) under "auto" and "fused" takes the plain loop (route
   "xla", B4 0 launches) and gives a `decoder_impl="xla"` Synthesizer's
   audio at the same seed bit for bit; at the reach it takes B4 (1
   launch); one train step at one past B6's reach under teacher "auto"
   runs the plain scan (B3 4, B3' 4, B6 0, the loss finite), and the same
   step under "fused" raises NotImplementedError before any B6 launch;
4. one JSON line of every kernel's numbers (its launches on each path,
   "cli" the sum of phase 3d's commands, "corpus" of phase 3e's three
   `train` runs, "variants" of phase 3f's counted runs, "mesh" of phase
   3g's, "geometry" of phase 3h's; the wide configurations' rows, B3, B3',
   B4 and B6 past their single-block widths, with phase 3i's launches, the
   grid B3 and B3' with phase 3j's, and the streaming grid B3 and B3'
   with phase 3k's), the
   card's line before it, and last
   `{"ok": true, "device":
   {...}}`.

Without CUDA, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


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


def gru_inputs(dev, B, T, D, H, seed, empty_row=False):
    """Seeded GRU inputs on the card: xs, wx, wh, b, a ragged and a full
    mask (lengths between T // 2 and T; with `empty_row`, row 0 of the
    ragged mask is all padding), and an output gradient."""
    import torch

    g = torch.Generator().manual_seed(seed)
    xs = torch.randn(B, T, D, generator=g).to(dev)
    wx = (torch.randn(D, 3 * H, generator=g) / D**0.5).to(dev)
    # Orthogonal rows up to H = 1104; past it a scaled normal (the host's QR
    # of a (3H, H) matrix grows as H^3).
    wh = (torch.nn.init.orthogonal_(torch.empty(H, 3 * H), generator=g) if H <= 1104
          else torch.randn(H, 3 * H, generator=g) / H**0.5).to(dev)
    b = (0.1 * torch.randn(3 * H, generator=g)).to(dev)
    lengths = torch.randint(max(T // 2, 1), T + 1, (B,), generator=g).to(dev)
    ragged = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    if empty_row:
        ragged[0] = 0.0
    dout = torch.randn(B, T, H, generator=g).to(dev)
    return xs, wx, wh, b, {"ragged": ragged, "full": torch.ones(B, T, device=dev)}, dout


def kernel_ptxas(source: str, match: str, no_spill: str) -> dict:
    """What ptxas reported for the kernels of csrc/<source>.cu whose name
    holds `match`; those whose name holds `no_spill` must not spill or use
    local memory."""
    from sstts_torch.ops import build

    found = {k: v for k, v in build.ptxas_report(source).items() if match in k}
    if not found:
        raise AssertionError(f"ptxas reported no kernel named *{match}* in {source}.cu")
    for name, info in found.items():
        log(f"  ptxas {name}: {info['registers']} registers, {info['stack_bytes']} bytes "
            f"stack, {info['spill_store_bytes']}/{info['spill_load_bytes']} bytes spill "
            f"stores/loads")
        if no_spill in name and (info["stack_bytes"] or info["spill_store_bytes"]
                                 or info["spill_load_bytes"]):
            raise AssertionError(f"{name} uses local memory: {info}")
    return found


def gru_ptxas(match: str) -> dict:
    """The kernels of csrc/gru.cu; the H = 128 ones must not spill."""
    return kernel_ptxas("gru", match, "h128")


def gru_kind(H: int) -> str:
    """The kind of CUDA recurrence `ops/gru.py:kernel_config` gives width H,
    with the wide kind's cluster size and batch rows a cluster at B = 32,
    the grid kind's blocks and units a
    block and, where its blocks stream part of their slice, the K columns
    of each slice row streamed (forward / backward) and "-bulk" where the
    streamed tiles move as bulk copies."""
    from sstts_torch.ops import gru

    kind, cluster = gru.kernel_config(H)
    if kind == gru.KIND_GRID:
        shapes = [gru.grid_shape(H, b) for b in (False, True)]
        streamed = "-S{}/{}".format(*(gs["S"] for gs in shapes)) if shapes[1]["S"] else ""
        bulk = "-bulk" if shapes[1]["bulk"] else ""
        return f"grid-NB{cluster}-U{shapes[0]['U']}{streamed}{bulk}"
    if kind == gru.KIND_WIDE:
        held = gru.wide_clusters(cluster, "cuda")
        return f"wide-C{cluster}-Bt{gru.wide_rows(H, 32, cluster, held)}"
    return {gru.KIND_H128: "h128", gru.KIND_GENERIC: "generic"}[kind]


#: (B, T, D, H) beside the main shape: one step, an odd length (both the
#: H = 128 kernels), the generic kernels at the tiny config's H = 16, and
#: widths that are no multiple of 4 (the projection's ragged tiles and
#: scalar stores); where T > 1, row 0 of the ragged mask is all padding.
GRU_SIDE_SHAPES = [(32, 1, 128, 128), (5, 37, 128, 128), (4, 24, 16, 16), (3, 1, 16, 16),
                   (2, 9, 10, 5)]


def check_gru(dev):
    import torch

    from sstts_torch.ops import build, gru
    from sstts_torch.ops.gru import (
        gru_sequence, gru_sequence_forward_plain, gru_sequence_plain,
    )

    ptxas = {**gru_ptxas("gru_fwd"), **gru_ptxas("gru_input_proj")}
    # f32 both sides, 800 dependent steps, sums in another order: 1e-4.
    tol = 1e-4
    checks = []
    for shape in [(32, 800, 128, 128)] + GRU_SIDE_SHAPES:
        B, T, D, H = shape
        kind = gru_kind(H)
        xs, wx, wh, b, masks, _ = gru_inputs(
            dev, *shape, seed=1, empty_row=shape in GRU_SIDE_SHAPES and T > 1)
        for mask_name, mask in masks.items():
            for reverse in (False, True):
                ref, ref_gates, ref_hprev = gru_sequence_forward_plain(
                    xs, wx, wh, b, mask, reverse)
                got = gru_sequence(xs, wx, wh, b, mask, reverse)
                # What training launches: the same kernel, gates and carries kept.
                got_s, gates, hprev = gru._kernel(xs, wx, wh, b, mask, reverse, save=True)
                torch.cuda.synchronize()
                errs = {"out": max_err(got, ref), "out_saving": max_err(got_s, ref),
                        "gates": max_err(gates, ref_gates),
                        "hprev": max_err(hprev, ref_hprev)}
                case = f"T{T}-H{H}-{kind}-{mask_name}-{'rev' if reverse else 'fwd'}"
                log(f"  B3 gru_sequence {case}: max_abs_err {errs} (tol {tol})")
                if not max(errs.values()) <= tol:
                    raise AssertionError(f"gru_sequence {case}: {errs} > {tol}")
                checks.append({"case": case, "max_abs_err": max(errs.values()),
                               "errors": errs, "tol": tol})
    # Main-path call: post-CBHG direction, all frames valid.
    B, T, D, H = 32, 800, 128, 128
    xs, wx, wh, b, masks, _ = gru_inputs(dev, B, T, D, H, seed=1)
    full = masks["full"]
    ms = cuda_ms(lambda: gru_sequence(xs, wx, wh, b, full, False))
    ms_saving = cuda_ms(lambda: gru._kernel(xs, wx, wh, b, full, False, save=True))
    plain = cuda_ms(lambda: gru_sequence_plain(xs, wx, wh, b, full, False), 1, 3)
    # The two stages apart, through the library's own entry points.
    lib = build.load("gru", gru.SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gx = torch.empty(B, T, 3 * H, device=dev)
    out = torch.empty(B, T, H, device=dev)

    def stage(fn, *args):
        build.check(lib, getattr(lib, fn)(*args, stream), fn)

    proj_ms = cuda_ms(lambda: stage(
        "sstts_gru_input_proj", xs.data_ptr(), wx.data_ptr(), b.data_ptr(),
        gx.data_ptr(), B * T, D, 3 * H))
    rec_ms = cuda_ms(lambda: stage(
        "sstts_gru_recurrence", gx.data_ptr(), wh.data_ptr(), full.data_ptr(),
        out.data_ptr(), None, None, None, B, T, H, 0, *gru.kernel_config(H)))
    log(f"  B3 stages at b={B}, T={T}: input projection {proj_ms:.4f} ms, recurrence "
        f"{rec_ms:.4f} ms; the wrapper {ms:.4f} ms, saving the gates {ms_saving:.4f} ms")
    # One PyTorch call with the same function when every step is valid:
    # cuDNN's GRU (gates r, z, n; r multiplies h @ W_hn + b_hn, b_hn = 0).
    lib_gru = cudnn_gru(dev, wx, wh, b)
    with torch.no_grad():
        lib_err = max_err(lib_gru(xs)[0], gru_sequence(xs, wx, wh, b, full, False))
        lib_ms = cuda_ms(lambda: lib_gru(xs))
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
        "library_ms": lib_ms, "ms_saving_gates": ms_saving,
        "ms_input_projection": proj_ms, "ms_recurrence": rec_ms, "ptxas": ptxas,
        "shape": [B, T, D, H], "checks": checks,
    }


def cudnn_gru(dev, wx, wh, b):
    """torch.nn.GRU with the port's weights (b_hh = 0): the library yardstick,
    the same function only when every step is valid."""
    import torch

    lib = torch.nn.GRU(wx.shape[0], wh.shape[0], batch_first=True).to(dev)
    with torch.no_grad():
        lib.weight_ih_l0.copy_(wx.T)
        lib.weight_hh_l0.copy_(wh.T)
        lib.bias_ih_l0.copy_(b)
        lib.bias_hh_l0.zero_()
    return lib


def check_gru_backward(dev):
    """B3's backward recurrence against its plain version at the encoder's
    (T=128) and the post-CBHG's (T=515) training lengths, one step, an odd
    length and the generic kernel's H = 16; then its time alone, the whole
    backward of the autograd.Function (recurrence and the four cuBLAS
    products) and cuDNN's whole backward."""
    import torch

    from sstts_torch.ops import gru
    from sstts_torch.ops.gru import (
        gru_sequence, gru_sequence_backward, gru_sequence_backward_plain,
        gru_sequence_forward_plain,
    )

    ptxas = gru_ptxas("gru_bwd")
    # f32 both sides; 515 dependent steps in another summation order, held
    # relative to the largest value: 1e-4.
    tol = 1e-4
    checks, main = [], None
    for shape in [(32, 128, 128, 128), (32, 515, 128, 128)] + GRU_SIDE_SHAPES:
        B, T, D, H = shape
        kind = gru_kind(H)
        xs, wx, wh, b, masks, dout = gru_inputs(
            dev, *shape, seed=11, empty_row=shape in GRU_SIDE_SHAPES and T > 1)
        for mask_name, mask in masks.items():
            for reverse in (False, True):
                # The inputs a training step hands it (the plain forward's
                # gates are held to the kernel's in check_gru).
                _, gates, hprev = gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
                got = gru_sequence_backward(dout, gates, hprev, wh, mask, reverse)
                ref = gru_sequence_backward_plain(dout, gates, hprev, wh, mask, reverse)
                torch.cuda.synchronize()
                errs = {
                    "dgx": max_err(got[0], ref[0]) / max(float(ref[0].abs().max()), 1e-30),
                    "dgh": max_err(got[1], ref[1]) / max(float(ref[1].abs().max()), 1e-30),
                }
                case = f"T{T}-H{H}-{kind}-{mask_name}-{'rev' if reverse else 'fwd'}"
                log(f"  B3 backward {case}: relative errors {errs} (tol {tol})")
                if not max(errs.values()) <= tol:
                    raise AssertionError(f"gru_sequence_backward {case}: {errs}")
                abs_err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
                checks.append({"case": case, "max_abs_err": abs_err, "rel_errors": errs, "tol": tol})
                if T == 515 and mask_name == "ragged" and not reverse:
                    main = (xs, wx, wh, b, dout, gates.contiguous(), hprev.contiguous(), mask)
    xs, wx, wh, b, dout, gates, hprev, mask = main
    B, T, D = xs.shape
    H = wh.shape[0]
    ms = cuda_ms(lambda: gru_sequence_backward(dout, gates, hprev, wh, mask, False))
    plain = cuda_ms(lambda: gru_sequence_backward_plain(dout, gates, hprev, wh, mask, False), 1, 3)
    # The whole backward of the Function: the recurrence and dxs, dWx, dWh,
    # db, as autograd runs it (its forward is not in the time).
    leaves = [t.clone().requires_grad_() for t in (xs, wx, wh, b)]
    y = gru_sequence(*leaves, mask, False)
    ms_whole = cuda_ms(lambda: torch.autograd.grad(y, leaves, dout, retain_graph=True))
    # Library yardstick: cuDNN's whole GRU backward (fwd+bwd minus fwd), the
    # same function only when every step is valid (b_hh = 0).
    lib = cudnn_gru(dev, wx, wh, b)
    xs_g = xs.clone().requires_grad_()

    def fwd_bwd():
        lib.zero_grad(set_to_none=True)
        xs_g.grad = None
        lib(xs_g)[0].backward(dout)

    with torch.no_grad():
        lib_fwd = cuda_ms(lambda: lib(xs))
    lib_ms = cuda_ms(fwd_bwd) - lib_fwd
    log(f"  B3 backward at b={B}, T={T}: recurrence alone {ms:.4f} ms; the whole backward "
        f"(recurrence + dxs, dWx, dWh, db) {ms_whole:.4f} ms; cuDNN's whole backward "
        f"{lib_ms:.4f} ms")
    n_bytes = nbytes(dout, gates, hprev, wh, mask) + 2 * B * T * 3 * H * 4
    n_ops = 2 * B * T * 3 * H * H
    bms, by = bound_ms(n_bytes, n_ops, "f32")
    return {
        "name": "gru_sequence_backward", "route": "cuda",
        "source": "sstts_torch/csrc/gru.cu",
        "replaces": "sstts/ops/pallas_gru.py:126",
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "ms_whole_backward": ms_whole, "ptxas": ptxas,
        "shape": [B, T, D, H], "checks": checks,
    }


#: The GRU kernels' widths past 137 held at full size (B = 32; T = 800
#: forward, 515 backward): the wide kind's (D = H) the first past the
#: generic kernels, the default's doubled (phase 3i's BiGRUs) and 512 (a
#: cluster of 16 taking 5 rows of the batch); the grid kind's (D =
#: 128, the model's highway width) 560, 752 (phase 3j's BiGRUs: the
#: reference kernel's reach at D = 128 on 16 MiB of VMEM) and 1104 (on 32
#: MiB); past 1419, where its blocks stream part of their slice, 1420
#: (phase 3k's BiGRUs: the backward streams), 2048 (both stream; L2 holds
#: what they stream) and the widest H taken, 5456 (read from HBM every
#: step).  Beside them: the wide kind's one step and an odd length (37) at
#: B = 1, 3, 4 and 33, whose last tile of batch rows is not full (33 at 139:
#: 17 tiles of 2 rows; at 301 and 512: 7 of 5), at widths no cluster
#: divides (139, 301), with D != H, and at B = 177 at 139, tiles of the
#: most rows (8) in more clusters than an H100 SXM holds at once (two
#: waves: what a card that holds too few clusters for one wave runs); the
#: grid kind's one step, an odd
#: length (37) at B = 1, 3 and 33, widths whose last block owns fewer units
#: (561: one of 5; 1103: 5 of 9; 2113: 5 of 17, two gate items a thread)
#: and 1025, 2048 and 5456.
GRU_WIDE_HIDDEN = (138, 256, 512, 560, 752, 1104, 1420, 2048, 5456)
GRU_WIDE_SIDE_SHAPES = [(3, 1, 64, 139), (1, 37, 64, 139), (33, 37, 64, 139),
                        (177, 37, 64, 139),
                        (4, 37, 96, 301), (1, 1, 96, 301), (33, 37, 96, 301),
                        (3, 37, 96, 256), (33, 1, 128, 512), (3, 37, 128, 512),
                        (32, 1, 128, 752), (1, 37, 128, 560), (3, 37, 128, 1104),
                        (33, 37, 128, 752), (5, 9, 64, 561), (2, 9, 128, 1103),
                        (2, 9, 128, 1025), (2, 9, 128, 2048), (3, 9, 128, 2113),
                        (1, 3, 64, 5456)]
#: The width each kind's row of the kernels line is read at.
GRU_WIDE_MAIN = {"wide": 256, "grid": 752, "streamed": 1420}

#: What the card keeps of Wh between steps at most: every SM's shared
#: memory (132 x 232,448 bytes) and L2 (50 MB on the H100 data sheet).
#: The bytes of Wh beyond them are read again every step.
KEPT_BYTES = 132 * 232448 + 50 * 2**20


def wide_kind(H: int) -> str:
    """"wide", "grid" or "streamed" (the grid kind whose blocks stream part
    of their slice of Wh): the kind of recurrence past 137 width H
    takes."""
    kind = gru_kind(H)
    return "streamed" if "-S" in kind else kind.split("-")[0]


def gru_bound(n_bytes: float, n_ops: float, H: int, T: int) -> dict:
    """The bound of a recurrence whose inputs and outputs move `n_bytes`
    once and whose FMAs are `n_ops` f32 operations, with its two terms:
    the operations at the f32 peak, and the bytes, `n_bytes` plus the bytes
    of Wh (12 H^2) past KEPT_BYTES read once a step for T steps, at HBM's
    rate."""
    streamed = max(0, 12 * H * H - KEPT_BYTES) * T
    ms, by = bound_ms(n_bytes + streamed, n_ops, "f32")
    return {"bound_ms": ms, "bound_by": by,
            "bound_terms_ms": {"operations": n_ops / PEAK_OPS["f32"] * 1e3,
                               "bytes": (n_bytes + streamed) / HBM_BYTES_PER_S * 1e3},
            "wh_bytes_not_kept_a_step": streamed // T}


def wide_input_width(H: int) -> int:
    """D of a main width's case: H for the wide kind, the model's 128 past."""
    return H if wide_kind(H) == "wide" else 128


def wide_gru_cases(dev, T: int, seed: int, kind: str):
    """(shape, inputs) of every case of `kind` at forward length T; row 0 of
    a ragged mask is all padding where T > 1."""
    main = [(32, T, wide_input_width(H), H) for H in GRU_WIDE_HIDDEN]
    for shape in main + GRU_WIDE_SIDE_SHAPES:
        if wide_kind(shape[3]) == kind:
            yield shape, gru_inputs(dev, *shape, seed=seed, empty_row=shape[1] > 1)


@functools.lru_cache(maxsize=None)
def check_gru_wide_counts():
    """The wrapper's rule (`kernel_config`, `wide_rows`, `wide_shape`'s
    shared memory and threads, `grid_smem_bytes`, `grid_shape`'s resident K
    range R, `grid_exchange_floats`, `grid_scratch_floats`) against the
    library's own count at every H past 137 up to MAX_HIDDEN; the clusters
    of each size the card holds at once (`wide_clusters`, read from the
    card: the wide rule's Bt divides the batch by them), printed beside the
    H100 SXM's reference table (`WIDE_CLUSTERS`, the CPU's model), and at
    every H the wide kind takes, its B = 32 in one wave wherever the card's
    counts give the block the rows one wave needs (the card holds ceil(32 /
    Bt) of its clusters at once), two waves or more elsewhere; each
    configuration the card holds at once (clusters; the grid kind's
    blocks, which must all be resident) for the widths of GRU_WIDE_HIDDEN;
    a line of its own for each grid width.  It fails where the wrapper and
    the library disagree or a launch would be refused, not where the card
    differs from the table."""
    from sstts_torch.ops import build, gru

    lib = build.load("gru", gru.SIGNATURES)
    raw = {C: [lib.sstts_gru_wide_active_clusters(gru.WIDE_PROBE_HIDDEN, C, 1, b)
               for b in (0, 1)] for C in range(2, gru.MAX_CLUSTER + 1)}
    held = {C: gru.wide_clusters(C, "cuda") for C in raw}
    log(f"  B3 wide: clusters of C blocks the card holds at once (forward, backward), C = 2.."
        f"{gru.MAX_CLUSTER}: {raw}; the rule's counts {list(held.values())}, the H100 SXM's "
        f"reference table {list(gru.WIDE_CLUSTERS[2:])} "
        f"({'the same' if all(held[C] == gru.WIDE_CLUSTERS[C] for C in held) else 'differs'})")
    bad = {C: (n, raw[C]) for C, n in held.items()
           if n != min(raw[C]) or n != lib.sstts_gru_wide_clusters(C)}
    if bad:
        raise AssertionError(f"the wrapper's and the library's cluster counts differ: {bad}")
    waves, more_waves = {}, []
    for H in range(138, gru.MAX_HIDDEN + 1):
        kind, C = gru.kernel_config(H)
        if kind == gru.KIND_GRID:
            want = gru.grid_smem_bytes(H)
            got = (lib.sstts_gru_grid_smem_bytes(H, 0), lib.sstts_gru_grid_smem_bytes(H, 1))
            rows = [(lib.sstts_gru_grid_resident(H, b), gru.grid_shape(H, bool(b))["R"])
                    for b in (0, 1)]
            scratch = [(lib.sstts_gru_grid_scratch_floats(B, H, bwd),
                        gru.grid_scratch_floats(B, H, bool(bwd)),
                        lib.sstts_gru_grid_exchange_floats(B, H, bwd),
                        gru.grid_exchange_floats(B, H, bool(bwd)))
                       for B in (1, 33) for bwd in (0, 1)]
            if (got != want or max(got) > build.MAX_SMEM or lib.sstts_gru_grid_blocks(H) != C
                    or any(a != b for a, b in rows)
                    or any(a != b or c != d for a, b, c, d in scratch)):
                raise AssertionError(f"grid GRU H={H}, NB={C}: library {got}, wrapper {want}, "
                                     f"R {rows}, scratch {scratch}")
            continue
        for B in (1, 3, 32, 33, 64, 177):
            rows = gru.wide_rows(H, B, C, held[C])
            want = [rows] + [gru.wide_shape(H, C, rows, b)[k] for b in (0, 1)
                             for k in ("smem", "threads")]
            got = [lib.sstts_gru_wide_rows(H, B, C)] + [
                fn(H, C, rows, b) for b in (0, 1)
                for fn in (lib.sstts_gru_wide_smem_bytes, lib.sstts_gru_wide_threads)]
            if got != want or max(got[1], got[3]) > build.MAX_SMEM or rows < 1:
                raise AssertionError(f"wide GRU H={H}, C={C}, B={B}: library (rows, smem, "
                                     f"threads forward, backward) {got}, wrapper {want}")
        rows = gru.wide_rows(H, 32, C, held[C])
        waves[H] = [lib.sstts_gru_wide_active_clusters(H, C, rows, b) for b in (0, 1)]
        if min(waves[H]) < 1:
            raise AssertionError(f"wide GRU H={H}, C={C}, Bt={rows}: the card holds no "
                                 f"cluster: {waves[H]}")
        one_wave = rows == -(-32 // held[C])  # the block holds the rows one wave needs
        if one_wave and min(waves[H]) < -(-32 // rows):
            raise AssertionError(f"wide GRU H={H}, C={C}, Bt={rows}: the card holds "
                                 f"{waves[H]} clusters at once, B = 32 needs {-(-32 // rows)}")
        if not one_wave:
            more_waves.append(H)
    log(f"  B3 wide: B = 32 in one wave of clusters at every H the wide kind takes, 138.."
        f"{max(waves)}, but {len(more_waves)} widths where the card's counts leave the block "
        f"too few rows ({more_waves[:8]}{'...' if len(more_waves) > 8 else ''}: more waves)"
        f" (the fewest clusters held at once {min(min(v) for v in waves.values())})")
    active = {}
    for H in GRU_WIDE_HIDDEN:
        C = gru.kernel_config(H)[1]
        if wide_kind(H) != "wide":
            shapes = [gru.grid_shape(H, b) for b in (False, True)]
            active[H] = {"blocks": C, "units": shapes[0]["U"],
                         "smem_bytes": gru.grid_smem_bytes(H),
                         "resident_k": [gs["R"] for gs in shapes],
                         "streamed_k": [gs["S"] for gs in shapes],
                         "threads": [lib.sstts_gru_grid_threads(H, b) for b in (0, 1)],
                         "forward": lib.sstts_gru_grid_active_blocks(H, 0),
                         "backward": lib.sstts_gru_grid_active_blocks(H, 1)}
            if min(active[H]["forward"], active[H]["backward"]) < C:
                raise AssertionError(f"grid GRU H={H}: the card cannot hold its {C} blocks "
                                     f"at once: {active[H]}")
            log(f"  B3 grid H={H}: {C} blocks of {shapes[0]['U']} units, shared memory "
                f"{active[H]['smem_bytes']} bytes forward / backward, K columns of a slice "
                f"row in shared memory {active[H]['resident_k']}, streamed "
                f"{active[H]['streamed_k']}, blocks the card holds at once "
                f"{active[H]['forward']} / {active[H]['backward']}")
            continue
        rows = gru.wide_rows(H, 32, C, held[C])
        shapes = [gru.wide_shape(H, C, rows, b) for b in (False, True)]
        active[H] = {"cluster": C, "rows": rows, "clusters": -(-32 // rows),
                     "card_clusters": held[C], "reference_clusters": gru.WIDE_CLUSTERS[C],
                     "smem_bytes": [ws["smem"] for ws in shapes],
                     "threads": [ws["threads"] for ws in shapes], "k_slices": shapes[0]["KS"],
                     "forward": waves[H][0], "backward": waves[H][1]}
    log(f"  B3 wide: the wrapper's shared-memory (and the grid kind's resident range and "
        f"scratch) counts equal the library's for H = 138..{gru.MAX_HIDDEN}; configurations "
        f"the card holds at once: {active}")
    return active


def check_gru_wide(dev, kind: str):
    """B3's kernels past H = 137 of `kind` ("wide": a cluster a sequence;
    "grid": one cooperative grid a direction, the batch as the rows of each
    block's product; "streamed": the grid kind whose blocks stream the part
    of their slice of Wh that shared memory cannot hold) against the plain
    version at their widths of GRU_WIDE_HIDDEN (B = 32, T = 800) and side
    shapes, full and ragged masks, both directions, with and without the
    saved gates, two launches bit-equal; the time at each main width beside
    cuDNN's nn.GRU (in turns with the kernel, three rounds: its median and
    spread), the plain version and the bound with both its terms; the
    launches it made."""
    import torch

    from sstts_torch.ops import gru
    from sstts_torch.ops.gru import gru_sequence, gru_sequence_forward_plain, gru_sequence_plain

    ptxas = gru_ptxas("gru_fwd_wide" if kind == "wide" else "gru_fwd_grid")
    active = check_gru_wide_counts()
    tol = 1e-4  # as check_gru: f32 both sides, sums in another order
    checks, by_h = [], {}
    for shape, (xs, wx, wh, b, masks, _) in wide_gru_cases(dev, 800, seed=21, kind=kind):
        B, T, D, H = shape
        for mask_name, mask in masks.items():
            for reverse in (False, True):
                ref, ref_gates, ref_hprev = gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
                got = gru_sequence(xs, wx, wh, b, mask, reverse)
                got_s, gates, hprev = gru._kernel(xs, wx, wh, b, mask, reverse, save=True)
                torch.cuda.synchronize()
                errs = {"out": max_err(got, ref), "out_saving": max_err(got_s, ref),
                        "gates": max_err(gates, ref_gates), "hprev": max_err(hprev, ref_hprev)}
                if not torch.equal(got, got_s):  # the same sums in the same order
                    raise AssertionError(f"gru_sequence {shape}: two launches differ")
                rel = max(errs.values()) / max(float(ref.abs().max()), 1e-30)
                case = f"B{B}-T{T}-D{D}-H{H}-{gru_kind(H)}-{mask_name}-{'rev' if reverse else 'fwd'}"
                log(f"  B3 gru_sequence {case}: max_abs_err {errs}, relative to the largest "
                    f"output {rel:.2e} (tol {tol})")
                if not max(errs.values()) <= tol:
                    raise AssertionError(f"gru_sequence {case}: {errs} > {tol}")
                checks.append({"case": case, "max_abs_err": max(errs.values()),
                               "max_rel_err": rel, "tol": tol})
        if (B, T) != (32, 800):  # the main widths only (the side shapes hold B = 32, T = 1 too)
            continue
        full = masks["full"]
        lib_gru = cudnn_gru(dev, wx, wh, b)
        ms, lib_runs = [], []
        with torch.no_grad():
            for _ in range(3):  # in turns: cuDNN's reading moves from call to call
                ms.append(cuda_ms(lambda: gru_sequence(xs, wx, wh, b, full, False), 3, 5))
                lib_runs.append(cuda_ms(lambda: lib_gru(xs), 3, 5))
        ms, lib_ms = statistics.median(ms), statistics.median(lib_runs)
        # The plain version's time (a step loop of small launches, ~0.3 s
        # whatever H) at the row's width only.
        plain = (cuda_ms(lambda: gru_sequence_plain(xs, wx, wh, b, full, False), 1, 3)
                 if H == GRU_WIDE_MAIN[kind] else None)
        n_bytes = nbytes(xs, wx, wh, b, full) + B * T * H * 4
        bound = gru_bound(n_bytes, 2 * B * T * (D * 3 * H + H * 3 * H), H, T)
        by_h[H] = {"ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                   "library_ms_runs": lib_runs, **bound, "kind": gru_kind(H), **active[H]}
        log(f"  B3 {kind} H={H} ({gru_kind(H)}): {ms:.4f} ms, cuDNN nn.GRU {lib_ms:.4f} ms "
            f"(in turns: {', '.join(f'{x:.4f}' for x in lib_runs)}), plain {plain} ms, bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
            f"(terms {bound['bound_terms_ms']})")
    main_h = GRU_WIDE_MAIN[kind]
    main = by_h[main_h]
    return {
        "name": f"gru_sequence_{kind}", "route": "cuda",
        "source": "sstts_torch/csrc/gru.cu",
        "replaces": "sstts/ops/pallas_gru.py:69",
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "by_hidden": by_h, "ptxas": ptxas,
        "shape": [32, 800, wide_input_width(main_h), main_h], "checks": checks,
    }


def check_gru_backward_wide(dev, kind: str):
    """B3's backward recurrence past H = 137 of `kind` against its plain
    version at its widths of GRU_WIDE_HIDDEN (B = 32, T = 515) and side
    shapes, both masks and directions, two launches bit-equal; its time at
    each main width beside cuDNN's whole GRU backward (in turns, three
    rounds); the launches it made."""
    import torch

    from sstts_torch.ops.gru import (
        gru_sequence_backward, gru_sequence_backward_plain, gru_sequence_forward_plain,
    )

    ptxas = gru_ptxas("gru_bwd_wide" if kind == "wide" else "gru_bwd_grid")
    tol = 1e-4  # relative to the largest value, as check_gru_backward
    checks, by_h = [], {}
    for shape, (xs, wx, wh, b, masks, dout) in wide_gru_cases(dev, 515, seed=22, kind=kind):
        B, T, D, H = shape
        timed = None
        for mask_name, mask in masks.items():
            for reverse in (False, True):
                _, gates, hprev = gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
                got = gru_sequence_backward(dout, gates, hprev, wh, mask, reverse)
                again = gru_sequence_backward(dout, gates, hprev, wh, mask, reverse)
                ref = gru_sequence_backward_plain(dout, gates, hprev, wh, mask, reverse)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
                    raise AssertionError(f"gru_sequence_backward {shape}: two launches differ")
                errs = {
                    "dgx": max_err(got[0], ref[0]) / max(float(ref[0].abs().max()), 1e-30),
                    "dgh": max_err(got[1], ref[1]) / max(float(ref[1].abs().max()), 1e-30),
                }
                case = f"B{B}-T{T}-D{D}-H{H}-{gru_kind(H)}-{mask_name}-{'rev' if reverse else 'fwd'}"
                log(f"  B3 backward {case}: relative errors {errs} (tol {tol})")
                if not max(errs.values()) <= tol:
                    raise AssertionError(f"gru_sequence_backward {case}: {errs}")
                abs_err = max(max_err(got[0], ref[0]), max_err(got[1], ref[1]))
                checks.append({"case": case, "max_abs_err": abs_err, "rel_errors": errs,
                               "tol": tol})
                if mask_name == "ragged" and not reverse:
                    timed = (gates.contiguous(), hprev.contiguous(), mask)
        if (B, T) != (32, 515):  # the main widths only
            continue
        gates, hprev, mask = timed
        lib = cudnn_gru(dev, wx, wh, b)
        xs_g = xs.clone().requires_grad_()

        def fwd_bwd():
            lib.zero_grad(set_to_none=True)
            xs_g.grad = None
            lib(xs_g)[0].backward(dout)

        ms, lib_runs = [], []
        for _ in range(3):  # in turns, as the forward's
            ms.append(cuda_ms(
                lambda: gru_sequence_backward(dout, gates, hprev, wh, mask, False), 3, 5))
            with torch.no_grad():
                lib_fwd = cuda_ms(lambda: lib(xs), 3, 5)
            lib_runs.append(cuda_ms(fwd_bwd, 3, 5) - lib_fwd)
        ms, lib_ms = statistics.median(ms), statistics.median(lib_runs)
        plain = (cuda_ms(
            lambda: gru_sequence_backward_plain(dout, gates, hprev, wh, mask, False), 1, 3)
            if H == GRU_WIDE_MAIN[kind] else None)
        n_bytes = nbytes(dout, gates, hprev, wh, mask) + 2 * B * T * 3 * H * 4
        bound = gru_bound(n_bytes, 2 * B * T * 3 * H * H, H, T)
        by_h[H] = {"ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                   "library_ms_runs": lib_runs, **bound, "kind": gru_kind(H)}
        log(f"  B3 backward {kind} H={H} ({gru_kind(H)}): recurrence {ms:.4f} ms, cuDNN's "
            f"whole backward {lib_ms:.4f} ms (in turns: "
            f"{', '.join(f'{x:.4f}' for x in lib_runs)}), plain {plain} ms, bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
            f"(terms {bound['bound_terms_ms']})")
    main_h = GRU_WIDE_MAIN[kind]
    main = by_h[main_h]
    return {
        "name": f"gru_sequence_backward_{kind}", "route": "cuda",
        "source": "sstts_torch/csrc/gru.cu",
        "replaces": "sstts/ops/pallas_gru.py:126",
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "by_hidden": by_h, "ptxas": ptxas,
        "shape": [32, 515, wide_input_width(main_h), main_h], "checks": checks,
    }


def ring_tolerances(dt, main_case: bool, largest: float, largest_align: float):
    """Limits on a ring kernel's values (B4's mel and stop, B6's xs) and on
    its alignments, against the plain version.  f32 is the same arithmetic
    in another summation order: 2e-4 / 2e-5, as tests/test_pallas_decoder.py
    holds the JAX kernel.  bf16 rounds every product's operands, and a
    different f32 sum can round an activation to the neighbouring bf16
    value, which the steps carry forward: the main case is held as the
    first port's kernel was, 5e-2 of `largest` (at least 1) and 5e-2; the
    other cases to 5e-2 of `largest` and 1e-3 of the largest alignment, so
    that a chunk of keys or memory dropped or misplaced cannot pass."""
    import torch

    if dt == torch.float32:
        return 2e-4, 2e-5
    if main_case:
        return 5e-2 * max(1.0, largest), 5e-2
    return 5e-2 * largest, 1e-3 * largest_align


def check_teacher(dev):
    """B6 against its plain version: f32 at S=20, bf16 at the training
    shape (S=103), one utterance, an odd T, the longest T the library's
    count of shared memory takes (and the next refused before any launch),
    and the gradient through its autograd.Function; the launch's host time
    while the card is busy (packing the weights and the launch must not wait
    for it)."""
    import torch

    from sstts_torch.config import Config
    from sstts_torch.model.tacotron import Tacotron, init_state_dict
    from sstts_torch.ops import teacher as tops

    cfg = Config()
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=12))
    cell = model.decoder_cell.to(dev)
    Dm, P1 = 2 * cfg.arch.encoder_gru_units, cfg.arch.prenet_units[-1]
    g = torch.Generator().manual_seed(13)

    def inputs(B, T, S):
        memory = (0.5 * torch.randn(B, T, Dm, generator=g)).to(dev)
        lengths = torch.randint(min(40, T), T + 1, (B,), generator=g).to(dev)
        maskf = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
        with torch.no_grad():
            keys = cell.attention.init_keys(memory)
        pre = torch.relu(torch.randn(B, S, P1, generator=g)).to(dev)
        return pre, memory, keys, maskf

    w = tops.teacher_weights_from_cell(cell)
    B, T = 32, 128
    pre0, memory, keys, maskf = inputs(1, 8, 2)
    t_max = tops.longest_text(tops.library(), tops.dims(w, pre0, memory, keys))
    if t_max < 4096:
        raise AssertionError(f"fused_teacher_scan takes T up to {t_max} only")
    checks, main = [], None
    # (case, B, T, S, dtype), held by `ring_tolerances` (S103-bf16 the main
    # case).
    cases = [("S20-f32", 32, 128, 20, torch.float32),
             ("S103-bf16", 32, 128, 103, torch.bfloat16),
             ("B1-S103-bf16", 1, 128, 103, torch.bfloat16),
             ("T37-S20-f32", 5, 37, 20, torch.float32),
             ("T37-S40-bf16", 3, 37, 40, torch.bfloat16),
             (f"T{t_max}-S2-f32", 1, t_max, 2, torch.float32)]
    for case, Bc, Tc, S, dt in cases:
        pre, memory_c, keys_c, maskf_c = inputs(Bc, Tc, S)
        n0 = tops.fused_teacher_scan.launches
        with torch.no_grad():
            got = tops.fused_teacher_scan(w, pre, memory_c, keys_c, maskf_c, dt)
            ref = tops.fused_teacher_scan_plain(w, pre, memory_c, keys_c, maskf_c, dt)
        torch.cuda.synchronize()
        scale, align_max = float(ref[0].abs().max()), float(ref[1].max())
        tol_x, tol_a = ring_tolerances(dt, case == "S103-bf16", scale, align_max)
        errs = {"xs": max_err(got[0], ref[0]), "align": max_err(got[1], ref[1])}
        log(f"  B6 fused_teacher_scan {case}: {errs} (tol xs {tol_x:.3g}, align "
            f"{tol_a:.3g}; |xs| max {scale:.3g}, largest alignment {align_max:.3g})")
        if not (errs["xs"] <= tol_x and errs["align"] <= tol_a
                and tops.fused_teacher_scan.launches == n0 + 1):
            raise AssertionError(f"fused_teacher_scan {case}: {errs}")
        checks.append({"case": case, "max_abs_err": max(errs.values()), "tol": tol_x,
                       "tol_align": tol_a, "errors": errs})
        if case == "S20-f32":
            f32_case = (pre, memory_c, keys_c, maskf_c)
        if case == "S103-bf16":
            main = (pre, memory_c, keys_c, maskf_c, checks[-1], S)
    # One beyond the limit the wrapper refuses before any launch.
    pre, memory_c, keys_c, maskf_c = inputs(1, t_max + 1, 2)
    n0 = tops.fused_teacher_scan.launches
    try:
        with torch.no_grad():
            tops.fused_teacher_scan(w, pre, memory_c, keys_c, maskf_c, torch.float32)
        raise AssertionError(f"fused_teacher_scan took T={t_max + 1}")
    except NotImplementedError as e:
        log(f"  B6 fused_teacher_scan T={t_max + 1} refused: {e}")
    assert tops.fused_teacher_scan.launches == n0
    # The gradient through the Function (kernel forward, plain f32 recompute
    # backward) against autograd through the plain f32 scan, on the f32
    # case: the same backward arithmetic, so 1e-5 of each leaf's largest.
    params = [p for p in cell.parameters()]
    f32_pre, memory, keys, maskf = f32_case

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
    pre, memory, keys, maskf, main_check, S = main
    # The host does not wait for the card: with the card held busy, packing
    # the live weights, the schedule (made once for the shape) and the
    # launch return long before the card is free.
    with torch.no_grad():
        tops.fused_teacher_scan(w, pre, memory, keys, maskf, torch.bfloat16)
    torch.cuda.synchronize()
    busy = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    busy[0].record()
    torch.cuda._sleep(200_000_000)
    busy[1].record()
    t0 = time.perf_counter()
    with torch.no_grad():
        tops.fused_teacher_scan(w, pre, memory, keys, maskf, torch.bfloat16)
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    busy_ms = busy[0].elapsed_time(busy[1])
    log(f"  B6 fused_teacher_scan: {host_ms:.3f} ms on the host while the card was busy "
        f"for {busy_ms:.3f} ms")
    if host_ms > busy_ms / 2:
        raise AssertionError("fused_teacher_scan's host side waited for the card")
    # Timed as a train step calls it: live f32 weights, packed in the call.
    bf = torch.bfloat16
    mem_b, keys_b = memory.to(bf), keys.to(bf)
    with torch.no_grad():
        ms = cuda_ms(lambda: tops.fused_teacher_scan(w, pre, mem_b, keys_b, maskf, bf), 3, 5)
        wc = tops.TeacherWeights(*[t.detach().contiguous() for t in tops._cast(w, bf)])
        plain = cuda_ms(lambda: tops.fused_teacher_scan_plain(
            wc, pre, mem_b, keys_b, maskf, bf), 1, 3)
    n_bytes = nbytes(*wc, pre, mem_b, keys_b, maskf) + 4 * B * S * (
        cfg.arch.decoder_gru_units + T)
    macs = sum(t.numel() for t in w if t.dim() == 2) + T * (keys.shape[-1] + Dm)
    n_ops = 2 * S * B * macs
    bms, by = bound_ms(n_bytes, n_ops, "bf16")
    # The bytes every block streams a step: the packed matrices and its keys
    # and memory (rows padded to 16 bytes).  The stream floor in the log
    # divides them by a rate this script does not measure, the 130.7 GB/s
    # one SM streamed from L2 through a 2 x 64 KB ring in
    # tools/sm_microbench.py (PERF.md), so it stays out of the kernels line.
    d = tops.dims(w, pre, memory, keys)
    step_bytes = sum(pr.rows * pr.row_bytes for pr in tops.step_products(w, d, bf))
    log(f"  B6 {ms:.4f} ms (before the redesign 7.4107); bound {bms:.4f} ms by {by}; "
        f"{step_bytes} bytes a step, a stream floor of "
        f"{S * step_bytes / 130.7e9 * 1e3:.4f} ms at sm_microbench's 130.7 GB/s")
    return {
        "name": "fused_teacher_scan", "route": "cuda",
        "source": "sstts_torch/csrc/teacher.cu",
        "replaces": "sstts/ops/pallas_decoder.py:447",
        "max_abs_err": main_check["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "stream_bytes_a_step": step_bytes,
        "longest_text": t_max, "host_ms_while_busy": host_ms,
        "shape": [B, T, S], "checks": checks,
    }


def check_decoder(dev):
    import torch

    from sstts_torch.config import Config, tiny_config
    from sstts_torch.model.tacotron import Tacotron, init_state_dict
    from sstts_torch.ops import decoder as dec

    cells = {}

    def inputs(cfg_name, B, T, S, dt, thr, min_steps, seed=3):
        # Prenet dropout on at the config's rate (0.5; "tiny-q" 0.25), drawn
        # in the kernel from `seed + 1`: the plain version draws the same
        # bits (`keep_bits`), so a mask that differs shows as a large error.
        if cfg_name not in cells:
            cfg = Config() if cfg_name == "default" else tiny_config()
            if cfg_name == "tiny-q":
                cfg = with_arch(cfg, prenet_dropout=0.25)
            model = Tacotron(cfg.arch, cfg.dataset)
            model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=2))
            cells[cfg_name] = (cfg, model.decoder_cell.to(dev).eval())
        cfg, cell = cells[cfg_name]
        Dm = 2 * cfg.arch.encoder_gru_units
        g = torch.Generator().manual_seed(seed)
        memory = (0.5 * torch.randn(B, T, Dm, generator=g)).to(dev)
        lengths = torch.randint(min(40, T), T + 1, (B,), generator=g).to(dev)
        mask = torch.arange(T, device=dev)[None] < lengths[:, None]
        with torch.no_grad():
            return dec.prepare_decode(
                cell, memory, mask, S, stop_threshold=thr, min_steps=min_steps,
                seed=seed + 1, matmul_dtype=dt,
            )

    checks, main = [], None
    # The longest text the kernel takes at the default widths, by the
    # library's own count of its shared memory; the first port's kernel took
    # T up to 4096 at least.
    t_max = dec.longest_text(dec.library(), inputs("default", 1, 8, 2, torch.bfloat16, 1.1, 8))
    if t_max < 4096:
        raise AssertionError(f"fused_decode takes T up to {t_max} only")

    # (case, config, B, T, S, dtype, stop threshold, min_steps).  Beside
    # chip_smoke's two cases, the ring's edges: the tiny config's narrow rows
    # (stop_w's 8 bytes padded to 16; at a dropout rate of 0.25 too, so that
    # the keep threshold is held at another value than 2^31), B=3 at T=300
    # (memory over 10 stages),
    # rows that stop at different steps (f32, so that no stop logit sits
    # across the threshold between the two), T=4096, and the longest T.
    cases = [
        ("S20-f32", "default", 32, 96, 20, torch.float32, 0.5, 8),
        ("S160-bf16", "default", 32, 96, 160, torch.bfloat16, 1.1, 8),
        ("tiny-f32", "tiny", 3, 11, 12, torch.float32, 0.5, 2),
        ("tiny-bf16", "tiny", 3, 11, 12, torch.bfloat16, 1.1, 2),
        ("tiny-q-f32", "tiny-q", 3, 11, 12, torch.float32, 1.1, 2),
        ("B3-T300-bf16", "default", 3, 300, 40, torch.bfloat16, 1.1, 8),
        ("stops-f32", "default", 8, 96, 24, torch.float32, 0.5, 1),
        ("T4096-bf16", "default", 2, 4096, 6, torch.bfloat16, 1.1, 8),
        (f"T{t_max}-bf16", "default", 1, t_max, 2, torch.bfloat16, 1.1, 8),
    ]
    for case, cfg_name, B, T, S, dt, thr, min_steps in cases:
        p = inputs(cfg_name, B, T, S, dt, thr, min_steps)
        with torch.no_grad():
            got = dec.decode_steps(p)
            ref = dec.decode_steps_plain(p)
        torch.cuda.synchronize()
        mel = float(ref["mel"].abs().max())
        main_case = case == "S160-bf16"
        tol_mel, tol_al = ring_tolerances(
            dt, main_case, mel if main_case else max(mel, float(ref["stop"].abs().max())),
            float(ref["align"].max()))
        errs = {k: max_err(got[k], ref[k]) for k in ("mel", "stop", "align")}
        fin_equal = bool(torch.equal(got["fin"], ref["fin"]))
        steps = sorted({int(v) for v in (ref["fin"] < 0.5).sum(1).tolist()})
        top = {k: float(ref[k].abs().max()) for k in ("mel", "stop", "align")}
        log(f"  B4 fused_decode {case}: {errs} fin_equal={fin_equal} (tol mel/stop "
            f"{tol_mel:.3g}, align {tol_al:.3g}; largest {top}; steps run {steps})")
        if not (fin_equal and errs["mel"] <= tol_mel and errs["stop"] <= tol_mel
                and errs["align"] <= tol_al):
            raise AssertionError(f"fused_decode {case}: {errs}, fin {fin_equal}")
        if case == "stops-f32" and len(steps) < 2:
            raise AssertionError(f"fused_decode {case}: every row stopped at {steps}")
        checks.append({"case": case, "max_abs_err": max(errs.values()),
                       "tol": tol_mel, "tol_align": tol_al, "errors": errs,
                       "steps_run": steps})
        if case == "S160-bf16":
            main = (p, checks[-1])
    # One beyond the limit the wrapper refuses before any launch.
    n0 = dec.decode_steps.launches
    p = inputs("default", 1, t_max + 1, 2, torch.bfloat16, 1.1, 8)
    try:
        with torch.no_grad():
            dec.decode_steps(p)
        raise AssertionError(f"fused_decode took T={t_max + 1}")
    except NotImplementedError as e:
        log(f"  B4 fused_decode T={t_max + 1} refused: {e}")
    assert dec.decode_steps.launches == n0
    p, main_check = main
    with torch.no_grad():
        ms = cuda_ms(lambda: dec.decode_steps(p), 3, 5)
        plain = cuda_ms(lambda: dec.decode_steps_plain(p), 1, 3)
    w = p.w
    B, T, Dm = p.memory.shape
    S, r, M = p.max_steps, p.reduction, p.n_mels
    A = p.keys.shape[-1]
    n_bytes = nbytes(*w, p.memory, p.keys, p.maskf) + 4 * B * S * (
        r * M + r + T + 1
    )
    macs = sum(getattr(w, n).numel() for n in dec._MATRICES) + T * (A + Dm)
    n_ops = 2 * S * B * macs
    bms, by = bound_ms(n_bytes, n_ops, "bf16")
    # The design's floor: every block streams the packed cell and its keys
    # and memory once a step (rows padded to 16 bytes), at the rate one SM
    # streams from L2 (sm_microbench's stream probe).
    step_bytes = p.packed.numel() + T * (dec.row_bytes(A, 2) + dec.row_bytes(Dm, 2))
    # The host does not wait for the card: with the card held busy, the
    # hoisted work (packing, the schedule's copy) and the launch return
    # long before the card is free.
    cfg, cell = cells["default"]
    memory = 0.5 * torch.randn(B, T, Dm, device=dev)
    mask = torch.ones(B, T, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    busy = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    busy[0].record()
    torch.cuda._sleep(200_000_000)
    busy[1].record()
    t0 = time.perf_counter()
    with torch.no_grad():
        dec.decode_steps(dec.prepare_decode(cell, memory, mask, S, stop_threshold=1.1,
                                            matmul_dtype=torch.bfloat16))
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    busy_ms = busy[0].elapsed_time(busy[1])
    log(f"  B4 prepare_decode + decode_steps: {host_ms:.3f} ms on the host while the "
        f"card was busy for {busy_ms:.3f} ms")
    if host_ms > busy_ms / 2:
        raise AssertionError("fused_decode's host side waited for the card")
    return {
        "name": "fused_decode", "route": "cuda",
        "source": "sstts_torch/csrc/decoder.cu",
        "replaces": "sstts/ops/pallas_decoder.py:169",
        "max_abs_err": main_check["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "shape": [B, T, S], "checks": checks,
        "stream_bytes_a_step": step_bytes,
    }


#: Phase 3i's architecture: the default Config() with its recurrent widths
#: doubled (BiGRUs of 256 a direction, attention and decoder GRUs of 512:
#: products of 1536 columns, memory of 512).
WIDE_ARCH = {"encoder_gru_units": 256, "post_gru_units": 256,
             "attention_gru_units": 512, "decoder_gru_units": 512}
#: Phase 3j's architecture: the default Config() with BiGRUs of 752 units a
#: direction, the reference GRU kernel's reach at the model's D = 128 on 16
#: MiB of VMEM (B3 and B3' on the grid kind; memory of 1504 columns, two
#: panels in B4 and B6).
GRID_ARCH = {"encoder_gru_units": 752, "post_gru_units": 752}
#: Phase 3k's architecture: BiGRUs of 1420 a direction, the first width
#: whose grid blocks stream part of their slice of Wh (B3 and B3' on the
#: grid kind, the backward streaming; memory of 2840 columns, three panels
#: in B4 and B6).
STREAM_ARCH = {"encoder_gru_units": 1420, "post_gru_units": 1420}
#: A ring-kernel cell with products of three column panels or more: the
#: query and the rows of keys (A = 2560), memory (Dm = 2176: 1024 + 1024 +
#: 128), and 3 Ha = 3 Hd = 1152.
PANEL_ARCH = {"attention_units": 2560, "encoder_gru_units": 1088,
              "attention_gru_units": 384, "decoder_gru_units": 384}


def decoder_cell(dev, seed: int, **arch):
    """(config, decoder cell on `dev`) of the default Config() with `arch`
    changed, from a seeded init."""
    from sstts_torch.config import Config
    from sstts_torch.model.tacotron import Tacotron, init_state_dict

    cfg = with_arch(Config(), **arch)
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=seed))
    return cfg, model.decoder_cell.to(dev).eval()


def panel_count(schedule) -> int:
    """The most column panels a product of `schedule` streams in."""
    rows = schedule.cpu().tolist()
    return max(sum(1 for r in rows if r[1] == pid and r[4] == 0) for pid in {r[1] for r in rows})


def check_decoder_wide(dev):
    """B4 in column panels against its plain version: phase 3i's cell at
    (B, T, S) = (32, 96, 160) with bf16 and f32 products (f32 also at 20
    steps, the narrow check's f32 case), and a cell of three panels a
    product or more at B = 2; the wide cell's time, bound and stream."""
    import torch

    from sstts_torch.ops import decoder as dec

    cells = {"wide": decoder_cell(dev, 2, **WIDE_ARCH), "panels": decoder_cell(dev, 2, **PANEL_ARCH)}

    def inputs(name, B, T, S, dt, thr, min_steps, seed=3):
        cfg, cell = cells[name]
        g = torch.Generator().manual_seed(seed)
        memory = (0.5 * torch.randn(B, T, 2 * cfg.arch.encoder_gru_units, generator=g)).to(dev)
        lengths = torch.randint(min(40, T), T + 1, (B,), generator=g).to(dev)
        mask = torch.arange(T, device=dev)[None] < lengths[:, None]
        with torch.no_grad():
            return dec.prepare_decode(cell, memory, mask, S, stop_threshold=thr,
                                      min_steps=min_steps, seed=seed + 1, matmul_dtype=dt)

    # (case, cell, B, T, S, dtype, stop threshold, min_steps), held by
    # `ring_tolerances` (wide-S160-bf16 the main case, as S160-bf16 is).
    cases = [("wide-S160-bf16", "wide", 32, 96, 160, torch.bfloat16, 1.1, 8),
             ("wide-S20-f32", "wide", 32, 96, 20, torch.float32, 0.5, 8),
             ("wide-S160-f32", "wide", 32, 96, 160, torch.float32, 1.1, 8),
             ("panels-f32", "panels", 2, 37, 12, torch.float32, 0.5, 2),
             ("panels-bf16", "panels", 2, 37, 12, torch.bfloat16, 1.1, 2)]
    checks, main = [], None
    for case, name, B, T, S, dt, thr, min_steps in cases:
        p = inputs(name, B, T, S, dt, thr, min_steps)
        n0 = dec.decode_steps.launches
        with torch.no_grad():
            got = dec.decode_steps(p)
            ref = dec.decode_steps_plain(p)
        torch.cuda.synchronize()
        main_case = case == "wide-S160-bf16"
        mel = float(ref["mel"].abs().max())
        tol_mel, tol_al = ring_tolerances(
            dt, main_case, mel if main_case else max(mel, float(ref["stop"].abs().max())),
            float(ref["align"].max()))
        errs = {k: max_err(got[k], ref[k]) for k in ("mel", "stop", "align")}
        fin_equal = bool(torch.equal(got["fin"], ref["fin"]))
        n_panels = panel_count(p.schedule)
        log(f"  B4 fused_decode {case}: {errs} fin_equal={fin_equal} (tol mel/stop "
            f"{tol_mel:.3g}, align {tol_al:.3g}; up to {n_panels} panels a product)")
        if not (fin_equal and errs["mel"] <= tol_mel and errs["stop"] <= tol_mel
                and errs["align"] <= tol_al and dec.decode_steps.launches == n0 + 1
                and n_panels >= (3 if name == "panels" else 2)):
            raise AssertionError(f"fused_decode {case}: {errs}, fin {fin_equal}, "
                                 f"{n_panels} panels")
        checks.append({"case": case, "max_abs_err": max(errs.values()), "tol": tol_mel,
                       "tol_align": tol_al, "errors": errs, "panels": n_panels})
        if main_case:
            main = (p, checks[-1])
    p, main_check = main
    with torch.no_grad():
        ms = cuda_ms(lambda: dec.decode_steps(p), 3, 5)
        plain = cuda_ms(lambda: dec.decode_steps_plain(p), 1, 3)
    w = p.w
    B, T, Dm = p.memory.shape
    S, r, M = p.max_steps, p.reduction, p.n_mels
    A = p.keys.shape[-1]
    n_bytes = nbytes(*w, p.memory, p.keys, p.maskf) + 4 * B * S * (
        r * M + r + T + 1)
    macs = sum(getattr(w, n).numel() for n in dec._MATRICES) + T * (A + Dm)
    bms, by = bound_ms(n_bytes, 2 * S * B * macs, "bf16")
    step_bytes = p.packed.numel() + T * (dec.row_bytes(A, 2) + dec.row_bytes(Dm, 2))
    params = sum(getattr(w, n).numel() for n in dec._MATRICES)
    log(f"  B4 wide cell (B={B}, T={T}, S={S}, bf16): {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bms:.4f} ms by {by}; {params} matrix parameters, {step_bytes} bytes "
        f"streamed a step")
    return {
        "name": "fused_decode_wide", "route": "cuda",
        "source": "sstts_torch/csrc/decoder.cu",
        "replaces": "sstts/ops/pallas_decoder.py:169",
        "max_abs_err": main_check["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "shape": [B, T, S], "checks": checks,
        "stream_bytes_a_step": step_bytes, "matrix_parameters": params,
    }


def check_teacher_wide(dev):
    """B6 in column panels against its plain version: phase 3i's cell at
    (B, T, S) = (32, 128, 103) with bf16 and f32 products, and a cell of
    three panels a product or more at B = 2; the wide cell's time as a train
    step calls it (live f32 weights packed in the call), and its bound."""
    import torch

    from sstts_torch.ops import teacher as tops

    cells = {"wide": decoder_cell(dev, 12, **WIDE_ARCH),
             "panels": decoder_cell(dev, 12, **PANEL_ARCH)}
    g = torch.Generator().manual_seed(13)

    def inputs(name, B, T, S):
        cfg, cell = cells[name]
        memory = (0.5 * torch.randn(B, T, 2 * cfg.arch.encoder_gru_units, generator=g)).to(dev)
        lengths = torch.randint(min(40, T), T + 1, (B,), generator=g).to(dev)
        maskf = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
        with torch.no_grad():
            keys = cell.attention.init_keys(memory)
        pre = torch.relu(torch.randn(B, S, cfg.arch.prenet_units[-1], generator=g)).to(dev)
        return tops.teacher_weights_from_cell(cell), pre, memory, keys, maskf

    cases = [("wide-S103-bf16", "wide", 32, 128, 103, torch.bfloat16),
             ("wide-S103-f32", "wide", 32, 128, 103, torch.float32),
             ("panels-f32", "panels", 2, 37, 12, torch.float32),
             ("panels-bf16", "panels", 2, 37, 12, torch.bfloat16)]
    checks, main = [], None
    for case, name, B, T, S, dt in cases:
        w, pre, memory, keys, maskf = inputs(name, B, T, S)
        n0 = tops.fused_teacher_scan.launches
        with torch.no_grad():
            got = tops.fused_teacher_scan(w, pre, memory, keys, maskf, dt)
            ref = tops.fused_teacher_scan_plain(w, pre, memory, keys, maskf, dt)
        torch.cuda.synchronize()
        scale, align_max = float(ref[0].abs().max()), float(ref[1].max())
        tol_x, tol_a = ring_tolerances(dt, case == "wide-S103-bf16", scale, align_max)
        errs = {"xs": max_err(got[0], ref[0]), "align": max_err(got[1], ref[1])}
        d = tops.dims(w, pre, memory, keys)
        n_panels = panel_count(tops._schedule(tops.step_products(w, d, dt), dev))
        log(f"  B6 fused_teacher_scan {case}: {errs} (tol xs {tol_x:.3g}, align "
            f"{tol_a:.3g}; up to {n_panels} panels a product)")
        if not (errs["xs"] <= tol_x and errs["align"] <= tol_a
                and tops.fused_teacher_scan.launches == n0 + 1
                and n_panels >= (3 if name == "panels" else 2)):
            raise AssertionError(f"fused_teacher_scan {case}: {errs}, {n_panels} panels")
        checks.append({"case": case, "max_abs_err": max(errs.values()), "tol": tol_x,
                       "tol_align": tol_a, "errors": errs, "panels": n_panels})
        if case == "wide-S103-bf16":
            main = (w, pre, memory, keys, maskf, checks[-1])
    w, pre, memory, keys, maskf, main_check = main
    bf = torch.bfloat16
    mem_b, keys_b = memory.to(bf), keys.to(bf)
    with torch.no_grad():
        ms = cuda_ms(lambda: tops.fused_teacher_scan(w, pre, mem_b, keys_b, maskf, bf), 3, 5)
        wc = tops.TeacherWeights(*[t.detach().contiguous() for t in tops._cast(w, bf)])
        plain = cuda_ms(lambda: tops.fused_teacher_scan_plain(
            wc, pre, mem_b, keys_b, maskf, bf), 1, 3)
    B, S, _ = pre.shape
    T, Dm = memory.shape[1:]
    n_bytes = nbytes(*wc, pre, mem_b, keys_b, maskf) + 4 * B * S * (w.gru0_wh.shape[0] + T)
    macs = sum(t.numel() for t in w if t.dim() == 2) + T * (keys.shape[-1] + Dm)
    bms, by = bound_ms(n_bytes, 2 * S * B * macs, "bf16")
    d = tops.dims(w, pre, memory, keys)
    step_bytes = sum(pr.rows * pr.row_bytes for pr in tops.step_products(w, d, bf))
    log(f"  B6 wide cell (B={B}, T={T}, S={S}, bf16): {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {bms:.4f} ms by {by}; {step_bytes} bytes streamed a step")
    return {
        "name": "fused_teacher_scan_wide", "route": "cuda",
        "source": "sstts_torch/csrc/teacher.cu",
        "replaces": "sstts/ops/pallas_decoder.py:447",
        "max_abs_err": main_check["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "stream_bytes_a_step": step_bytes,
        "shape": [B, T, S], "checks": checks,
    }


#: B2's and B5's times per launch before their redesign on TMA and wgmma
#: (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W), logged beside the new ones.
#: They are records, not readings of this run, so they stay out of the
#: `kernels` line (tools/compare_gl_builds.py times both designs in one run).
GL_MS_PREV = {"fused_reproject_analyze": 1.9111, "fused_reproject_analyze_momentum": 2.0116,
              "fused_gl_iteration": 3.9469}

#: (Bt, T) beside the main shape (32, 800), at the same widths: a batch the
#: cluster of two does not divide, a single utterance, a length that is no
#: multiple of 64, one below 64 and one no longer than the band (T <= 2 D).
GL_SIDE_SHAPES = [(3, 515), (1, 800), (3, 37), (2, 5)]

#: DatasetConfig fields of 44.1 kHz audio at n_fft 2048 with a 2048-sample
#: window (46.44 ms) and a 512-sample hop (11.61 ms): a support of 2047 lanes.
DS_44K = {"sample_rate": 44100, "n_fft": 2048, "win_len_ms": 46.44, "win_hop_ms": 11.61,
          "mel_fmax": 22050.0}
DS_24K = {"sample_rate": 24000, "mel_fmax": 12000.0}
#: 48 kHz and 44.1 kHz at n_fft 4096 and the reference's 50 / 12.5 ms window:
#: windows of 2400 and 2205 samples (supports of 2399 and 2204 lanes in wp
#: 2432 and 2304), hops of 600 and 551 (D = 3), 2049 bins (2 hp = 4096 in
#: the packed bf16 loop, 4352 in the f32 one).
DS_48K = {"sample_rate": 48000, "n_fft": 4096, "mel_fmax": 24000.0}
DS_44K_4096 = {"sample_rate": 44100, "n_fft": 4096, "mel_fmax": 22050.0}

#: Other geometries the kernels take, as (case, DatasetConfig fields, kernels,
#: loop dtypes): a 6.22 ms hop at the default window (137 samples, D = 8, the
#: most the whole-panel B2 takes; B5's stops at D = 4), a 16 kHz corpus
#: (window 800, hop 200: a support of 799 lanes in wp = 896, D = 3), and the
#: geometries of the wide configuration: 24 kHz at 50 / 12.5 ms (1199 lanes,
#: D = 3), hops of 10, 5 and 3 ms at 22.05 kHz (D = 5, 10, 16), 44.1 kHz at
#: n_fft 2048 (2047 lanes, D = 3), and past n_fft 2048 and D = 16: 48 kHz
#: and 44.1 kHz at n_fft 4096 (`DS_48K`, `DS_44K_4096`), hops of 2.86 and
#: 1.55 ms at 22.05 kHz (63 and 34 samples: D = 17, 32); and the f32 loop at
#: every geometry (the defaults' bf16 are the main shape).
GL_SIDE_GEOMETRIES = [
    ("hop137", {"win_hop_ms": 6.22}, ("B2",), ("bf16",)),
    ("16kHz", {"sample_rate": 16000, "n_fft": 1024, "mel_fmax": 8000.0}, ("B2", "B5"),
     ("bf16", "f32")),
    ("defaults", {}, ("B2", "B5"), ("f32",)),
    ("24kHz", DS_24K, ("B2", "B5"), ("bf16", "f32")),
    ("hop10ms", {"win_hop_ms": 10.0}, ("B2", "B5"), ("bf16", "f32")),
    ("hop5ms", {"win_hop_ms": 5.0}, ("B2", "B5"), ("bf16", "f32")),
    ("hop3ms", {"win_hop_ms": 3.0}, ("B2", "B5"), ("bf16", "f32")),
    ("44kHz", DS_44K, ("B2", "B5"), ("bf16", "f32")),
    ("48kHz", DS_48K, ("B2", "B5"), ("bf16", "f32")),
    ("44kHz4096", DS_44K_4096, ("B2", "B5"), ("bf16", "f32")),
    ("hop2.86ms", {"win_hop_ms": 2.86}, ("B2", "B5"), ("bf16", "f32")),
    ("hop1.55ms", {"win_hop_ms": 1.55}, ("B2", "B5"), ("bf16", "f32")),
]

#: Geometries past the kernels' envelope, which the wrappers must refuse
#: before any launch, as (DatasetConfig fields, kernels, loop dtype): more
#: than the reference kernels' 128 overlapping frames a side for B2 and B5
#: (an 8-sample hop of the default window, D = 137; B1 takes it), and more
#: than 256 for B1 too (a 4-sample hop, D = 275), at the default n_fft and
#: at n_fft 4096 (48 kHz, D = 599).
GL_REFUSED = [
    ({"win_hop_ms": 0.363}, ("B2", "B5"), "bf16"),
    ({"win_hop_ms": 0.363}, ("B2", "B5"), "f32"),
    ({"win_hop_ms": 0.182}, ("B1", "B2", "B5"), "bf16"),
    ({"win_hop_ms": 0.182}, ("B1", "B2", "B5"), "f32"),
    ({**DS_48K, "win_hop_ms": 0.0834}, ("B1", "B2", "B5"), "f32"),
]

#: Tolerance of an f32 kernel (the wide configuration's three tf32 products)
#: against its plain version (exact f32 products) on the card: relative L2
#: of one iteration's output.
F32_REL_TOL = 1e-5


def gl_inputs(dev, Bt, T, seed, ds=None, dtype=None, on_card=False):
    """Seeded inputs of B2 and B5 on the card, bf16 (or `dtype`), at the
    default config's widths (wp = 1152 lanes, 2 hp = 2048) or with the
    lanes of another dataset config `ds` (in bf16 2 hp = 2048 up to n_fft
    2048, the packed n_fft / 2 rounded up to 128 past it: 4096 at n_fft
    4096); in f32 with the f32 loop's bins (the unpacked n_fft / 2 + 1
    rounded up to 128: 2 hp = 2304 at n_fft 2048, 4352 at 4096).  Drawn on
    the CPU, or with `on_card` on the card (other values, made in
    milliseconds: for timing)."""
    import torch

    from sstts_torch.config import Config
    from sstts_torch.dsp.reproject import band_plan, padded_wss2d

    ds = ds or Config().dataset
    bf = dtype or torch.bfloat16
    hp = (max(1024, -(-(ds.n_fft // 2) // 128) * 128) if bf == torch.bfloat16
          else -(-(ds.n_fft // 2 + 1) // 128) * 128)
    wp = -(-(ds.win_len - 1) // 128) * 128
    length = (T - 1) * ds.hop_len
    plan = band_plan(ds.n_fft, ds.hop_len, ds.win_len, T, length)
    w_len = plan["w_len"]
    at = dev if on_card else "cpu"
    g = torch.Generator(at).manual_seed(seed)
    frames = torch.randn(Bt, T, wp, generator=g, device=at)
    frames[..., w_len:] = 0.0  # GEMM1's zero lanes
    w_inv = torch.randn(2 * hp, wp, generator=g, device=at) / 32
    w_inv[:, w_len:] = 0.0  # the loop's zero-padded synthesis columns
    return {
        "ds": ds, "plan": plan, "length": length, "wp": wp, "hp": hp,
        "frames": frames.to(dev, bf),
        "q": torch.randn(Bt, T, 2 * hp, generator=g, device=at).to(dev, bf),
        "mag2": torch.rand(Bt, T, 2 * hp, generator=g, device=at).to(dev, bf),
        "w_inv": w_inv.to(dev, bf),
        "w_fwd": (torch.randn(wp, 2 * hp, generator=g, device=at) / 32).to(dev, bf),
        "prev": torch.randn(Bt, T, 2 * hp, generator=g, device=at).to(dev, bf),
        "wss2d": padded_wss2d(plan, wp, dev),
    }


def gl_side_geometries(kernel):
    """(DatasetConfig, case name, loop dtype) of `GL_SIDE_GEOMETRIES` for B2
    or B5."""
    import torch

    from sstts_torch.config import Config

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    return [(dataclasses.replace(Config().dataset, **fields), tag, dtypes[dt])
            for tag, fields, kernels, dts in GL_SIDE_GEOMETRIES if kernel in kernels
            for dt in dts]


def gl_refusals(kernel, dev, wrapper, args_of):
    """The wrapper of B2 or B5 raises NotImplementedError on the card, and
    launches nothing, at each geometry of `GL_REFUSED` for it."""
    import torch

    from sstts_torch.config import Config

    for fields, kernels, dt in GL_REFUSED:
        if kernel not in kernels:
            continue
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
        x = gl_inputs(dev, 2, 70, 90, dataclasses.replace(Config().dataset, **fields), dtype)
        before = wrapper.launches
        try:
            wrapper(*args_of(x))
        except NotImplementedError as e:
            log(f"  {kernel} refuses {fields} {dt} (w_len {x['plan']['w_len']}, D "
                f"{x['plan']['d_max']}, 2 hp {2 * x['hp']}): {str(e)[:60]}...")
        else:
            raise AssertionError(f"{kernel} took {fields} {dt}, which it does not support")
        if wrapper.launches != before:
            raise AssertionError(f"{kernel} counted a launch it refused")


def b5_reference(q, mag2, w_inv, w_fwd, wss2d, w_len, hop, d_max):
    """What B5's launches are held to: its function, `gl_iteration_plain`,
    with GEMM1's sums exact (q @ w_inv summed in float64, rounded once to
    the f32 frames).  The plain version's own f32 GEMM1 sums in cuBLAS's
    order, and that order alone moves reprojected frames' bf16 rounding
    more often than the kernel's does: at phase 3h's 48 kHz launch it differs
    from the exact sums in 6.05% of the outputs, past `hold_gl`'s 5%, where
    the kernel differs in 1.90% (PERF.md §6).  GEMM2 and the renorm are the
    plain version's."""
    from sstts_torch.dsp.gl_fused import renorm
    from sstts_torch.dsp.reproject import shift_add_rows

    frames = (q.double() @ w_inv.double()).float()
    acc = shift_add_rows(frames, w_len, hop, d_max, 0, q.shape[-2])
    fr = (acc * wss2d).to(q.dtype)
    return renorm(fr.float() @ w_fwd.float(), mag2, mag2.shape[-1] // 2, q.dtype)


def rel_err(a, b) -> float:
    """Relative L2 error of a against b."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def hold_gl(kernel: str, case: str, a, b) -> dict:
    """B2's or B5's output `a` against its plain version's `b` on the same
    inputs; raises beyond the tolerance, else returns the check.

    f32 (the wide configuration's three tf32 products against exact f32
    ones): relative L2 within F32_REL_TOL.  bf16 B2: the kernel and the
    plain version round at the same points and differ only in f32
    summation order, which flips an output's last bf16 bit now and then:
    one bf16 step (2^-7) relative to the output's largest value (q, or s,
    the raw spectrum), and under 1% of the elements may differ at all.
    bf16 B5 (held to `b5_reference`, GEMM1's sums exact): the kernel's f32
    GEMM1 sums round otherwise, so a reprojected frame now and then rounds
    to the neighbouring bf16 value before GEMM2, and the renorm turns that
    into a phase change that is large only where |s| is near 0: relative
    L2 within 2^-7 and under 5% of the elements differing; the largest
    difference is reported."""
    import torch

    name = {"B2": "fused_reproject_analyze", "B5": "fused_gl_iteration"}[kernel]
    err, rel = max_err(a, b), rel_err(a, b)
    finite = bool(torch.isfinite(a.float()).all())
    if a.dtype == torch.float32:
        log(f"  {kernel} {name} {case}-f32: rel L2 {rel:.3e} max_abs_err {err:.3e} "
            f"(tol rel L2 {F32_REL_TOL})")
        if not (rel <= F32_REL_TOL and finite):
            raise AssertionError(f"{name} {case}-f32: {rel}, {err}")
        return {"case": f"{case}-f32", "max_abs_err": err, "rel_l2": rel,
                "tol_rel_l2": F32_REL_TOL}
    frac = float((a != b).float().mean())
    if kernel == "B2":
        t = 2.0**-7 * float(b.float().abs().max())
        log(f"  B2 {name} {case}: max_abs_err {err:.3e} differing {frac:.2e} "
            f"(tol {t:.3g}, < 1%)")
        if not (err <= t and frac < 1e-2 and finite):
            raise AssertionError(f"{name} {case}: {err}, {frac}")
        return {"case": case, "max_abs_err": err, "tol": t, "differing": frac}
    log(f"  B5 {name} {case}: rel L2 {rel:.3e} differing {frac:.2e} max_abs_err "
        f"{err:.3e} (tol rel L2 {2.0**-7:.3g}, < 5%)")
    if not (rel <= 2.0**-7 and frac < 5e-2 and finite):
        raise AssertionError(f"{name} {case}: {rel}, {frac}, {err}")
    return {"case": case, "max_abs_err": err, "rel_l2": rel, "tol_rel_l2": 2.0**-7,
            "differing": frac}


def hold_b2(args, prev, w_fwd_t, suffix: str, dev) -> list:
    """B2's launch on `args` (`reproject_analyze`'s first seven) against its
    plain version (exact f32 products) on the same inputs, classic and with
    momentum 0.99 from `prev`: q, and with momentum s (`hold_gl`)."""
    import torch

    from sstts_torch.dsp.gl_fused import reproject_analyze, reproject_analyze_plain
    from sstts_torch.synthesize import exact_f32

    checks = []
    for m in (0.0, 0.99):
        pv = prev if m else None
        got = reproject_analyze(*args, pv, m, w_fwd_t)
        with exact_f32(dev):
            ref = reproject_analyze_plain(*args, pv, m)
        torch.cuda.synchronize()
        for name, a, b in (("q", got[0], ref[0]), ("s", got[1], ref[1])):
            if a is not None:
                case = f"{'momentum' if m else 'classic'}-{name}{suffix}"
                checks.append(hold_gl("B2", case, a, b))
    return checks


def gl_geometry_times(dev, kernel: str) -> dict:
    """B2's or B5's time per launch at the main shape (32 x 800) at every
    geometry of `GL_SIDE_GEOMETRIES` beside the defaults, in each loop
    dtype, with the tile configuration the wrapper picks and the bound: the
    operations over 989 TFLOP/s in bf16, and in f32 as three tf32 products
    over 495 TFLOP/s (the kernel's arithmetic) with the f32-FMA bound (67
    TFLOP/s) beside it.  The inputs are made on the card.  Each geometry's
    launch is first held to its plain version on the same inputs
    (`hold_gl`): B2 classic and with momentum, B5.  At this shape a
    persistent wide block walks one to two of the 416 items, so a slab is
    reused across items, which the kernel checks at 3 x 150 frames (one item
    a block) do not reach."""
    import torch

    from sstts_torch.config import Config
    from sstts_torch.dsp import gl_fused as gl
    from sstts_torch.dsp.gl_tiles import k_major
    from sstts_torch.synthesize import exact_f32

    out = {}
    seen = set()
    cases = [(Config().dataset, "defaults", torch.bfloat16)] + gl_side_geometries(kernel)
    for ds, tag, dtype in cases:
        if (tag, dtype) in seen or tag == "hop137":
            continue
        seen.add((tag, dtype))
        x = gl_inputs(dev, 32, 800, 3, ds, dtype, on_card=True)
        plan, hp = x["plan"], x["hp"]
        w_len, d_max, hop = plan["w_len"], plan["d_max"], ds.hop_len
        wt = k_major(x["w_fwd"])
        rows = 32 * 800
        es = x["mag2"].element_size()
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        if kernel == "B2":
            cfg = gl.gl_tiles.config("gl_semi", x["wp"], hp, w_len, d_max, False, dtype)[0]
            args = (x["frames"], x["mag2"], x["w_fwd"], x["wss2d"], w_len, hop, d_max)
            checks = hold_b2(args, x["prev"], wt, f"-32x800-{tag}", dev)
            ms = cuda_ms(lambda: gl.reproject_analyze(*args, None, 0.0, wt), 3, 3)
            n_ops = 2 * rows * w_len * 2 * hp
            n_bytes = rows * w_len * es + nbytes(x["mag2"], x["w_fwd"][:w_len]) + rows * 2 * hp * es
        else:
            cfg = gl.gl_tiles.config("gl_fused", x["wp"], hp, w_len, d_max, True, dtype)[0]
            wit = k_major(x["w_inv"])
            args = (x["q"], x["mag2"], x["w_inv"], x["w_fwd"], x["wss2d"], w_len, hop, d_max)
            got = gl.gl_iteration(*args, wit, wt)
            with exact_f32(dev):
                ref = b5_reference(*args)
            checks = [hold_gl("B5", f"kernel-32x800-{tag}", got, ref)]
            del got, ref
            ms = cuda_ms(lambda: gl.gl_iteration(*args, wit, wt), 3, 3)
            n_ops = 2 * 2 * rows * w_len * 2 * hp
            n_bytes = (nbytes(x["q"], x["mag2"], x["w_inv"][:, :w_len], x["w_fwd"][:w_len])
                       + rows * 2 * hp * es)
        n_bytes += nbytes(x["wss2d"][:, :w_len])
        if name == "bf16":
            bms, by = bound_ms(n_bytes, n_ops, "bf16")
            extra = {}
        else:
            bms, by = bound_ms(n_bytes, 3 * n_ops, "tf32")
            by += " (3 x tf32)"
            extra = {"bound_ms_f32_fma": bound_ms(n_bytes, n_ops, "f32")[0]}
        if cfg == "wide":
            cfg += "-" + gl.gl_tiles.wide_sum(w_len, dtype)
        out[f"{tag}-{name}"] = {"config": cfg, "ms": ms, "bound_ms": bms, "bound_by": by,
                                "w_len": w_len, "d_max": d_max, "hp": hp, **extra,
                                "checks": checks}
        log(f"  {kernel} {tag} {name} ({cfg}, w_len {w_len}, D {d_max}, 2 hp {2 * hp}): "
            f"{ms:.4f} ms, bound {bms:.4f} ({by}; {bms / ms:.1%})"
            + (f", f32-FMA bound {extra['bound_ms_f32_fma']:.4f}" if extra else ""))
    return out


def host_us_per_launch(fn, n: int = 200) -> float:
    """Host time of one call of `fn` (a kernel wrapper: allocation, the
    tensor maps, the launch), the card kept busy but never waited for."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def check_gl(dev):
    import torch

    from sstts_torch.dsp.gl_fused import (
        fused_reproject_analyze, reproject_analyze, reproject_analyze_plain,
    )
    from sstts_torch.dsp.gl_tiles import k_major

    checks = []

    def compare(Bt, T, seed, ds=None, tag="", dtype=torch.bfloat16):
        x = gl_inputs(dev, Bt, T, seed, ds, dtype)
        args = (x["frames"], x["mag2"], x["w_fwd"], x["wss2d"], x["plan"]["w_len"],
                x["ds"].hop_len, x["plan"]["d_max"])
        checks.extend(hold_b2(args, x["prev"], None,
                              "" if (Bt, T) == (32, 800) else f"-{Bt}x{T}{tag}", dev))
        return x, args

    x, args = compare(32, 800, 5)
    for i, (Bt, T) in enumerate(GL_SIDE_SHAPES):
        compare(Bt, T, 50 + i)
    for i, (ds, tag, dtype) in enumerate(gl_side_geometries("B2")):
        compare(3, 150, 60 + i, ds, "-" + tag, dtype)
    gl_refusals("B2", dev, reproject_analyze, lambda x: (
        x["frames"], x["mag2"], x["w_fwd"], x["wss2d"], x["plan"]["w_len"],
        x["ds"].hop_len, x["plan"]["d_max"]))
    ptxas = kernel_ptxas("gl_semi", "gl_semi_kernel", "gl_semi_kernel")
    # The wide configuration's kernels at two blocks an SM (128 registers):
    # reported, a few bytes of spill allowed.
    ptxas.update(kernel_ptxas("gl_semi", "gl_semi_wide_kernel", "\0"))
    prev = x["prev"]
    w_fwd_t = k_major(x["w_fwd"])  # the loop makes it once per call
    ms = cuda_ms(lambda: reproject_analyze(*args, None, 0.0, w_fwd_t))
    plain = cuda_ms(lambda: reproject_analyze_plain(*args, None, 0.0), 2, 3)
    ms_m = cuda_ms(lambda: reproject_analyze(*args, prev, 0.99, w_fwd_t))
    ms_t = cuda_ms(lambda: reproject_analyze(*args, None, 0.0))
    host_us = host_us_per_launch(lambda: reproject_analyze(*args, None, 0.0, w_fwd_t))
    ds = x["ds"]
    host_us_whole = host_us_per_launch(lambda: fused_reproject_analyze(
        x["frames"], x["mag2"], x["w_fwd"], ds.n_fft, ds.hop_len, ds.win_len,
        x["length"], wss2d=x["wss2d"], w_fwd_t=w_fwd_t))
    Bt, T, wp, hp, w_len = 32, 800, x["wp"], x["hp"], x["plan"]["w_len"]
    # What the function needs: lanes from w_len on are zero in the frames,
    # w_fwd's rows and the envelope, so neither read nor multiplied.
    rows = Bt * T
    n_bytes = (rows * w_len * 2
               + nbytes(x["mag2"], x["w_fwd"][:w_len], x["wss2d"][:, :w_len])
               + rows * 2 * hp * 2)
    n_ops = 2 * rows * w_len * 2 * hp
    bms, by = bound_ms(n_bytes, n_ops, "bf16")
    log(f"  B2 times: {ms:.4f} ms (before the redesign "
        f"{GL_MS_PREV['fused_reproject_analyze']}), momentum {ms_m:.4f} "
        f"({GL_MS_PREV['fused_reproject_analyze_momentum']}), transposing w_fwd "
        f"inside the call {ms_t:.4f}; bound {bms:.4f}: {bms / ms:.1%} of it; host "
        f"{host_us:.1f} us a launch, {host_us_whole:.1f} us with the edge repair")
    by_geometry = gl_geometry_times(dev, "B2")
    return {
        "name": "fused_reproject_analyze", "route": "cuda",
        "source": "sstts_torch/csrc/gl_semi.cu",
        "replaces": "sstts/dsp/gl_fused.py:227",
        "max_abs_err": checks[0]["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "ms_momentum": ms_m, "ms_with_transpose": ms_t,
        "host_us_per_launch": host_us, "host_us_with_edge_repair": host_us_whole,
        "ptxas": ptxas, "shape": [Bt, T, wp, 2 * hp], "checks": checks,
        "ms_f32": by_geometry["defaults-f32"]["ms"], "by_geometry": by_geometry,
    }


#: B1's time per launch before its redesign (the kernel alone, and with its
#: mirror runs in torch; PERF.md, NVIDIA H100 80GB HBM3, 700.00 W), logged
#: beside the new one; a record, not a reading of this run.
B1_MS_PREV = {"kernel": 0.2566, "with_mirror_runs": 0.3811}

#: (case, DatasetConfig fields, Bt, T) beside the main shape (32, 800): a
#: batch of 3 at 515 frames, one utterance of 37, 3 of 5 frames (the head
#: and tail mirror runs meet), a hop of 137 samples (D = 8), one of 110
#: (D = 10: the kernel that takes D at run time), a 16 kHz corpus (w_len
#: 799 in 896 lanes, D = 3), 44.1 kHz at n_fft 2048 with a 128-sample
#: hop (w_len 2047, D = 15: in f32 no ring holds its rows, so the direct
#: configuration runs), and B2's and B5's geometries past n_fft 2048 and D
#: = 16 (`REPROJECT_WIDE`).
REPROJECT_SIDE = [
    ("3x515", {}, 3, 515), ("1x37", {}, 1, 37), ("3x5", {}, 3, 5),
    ("hop137", {"win_hop_ms": 6.22}, 3, 150), ("hop110", {"win_hop_ms": 5.0}, 2, 150),
    ("16kHz", {"sample_rate": 16000, "n_fft": 1024, "mel_fmax": 8000.0}, 1, 150),
    ("44kHz-hop128", {**DS_44K, "win_hop_ms": 2.9025}, 2, 150),
]

#: The geometries of `GL_SIDE_GEOMETRIES` past n_fft 2048 and D = 16, at
#: which B1 ("split", the reference run of phase 3h) is held at 2 x 150 and
#: timed at 32 x 800: the ring where it fits (48 and 44.1 kHz at n_fft 4096,
#: D = 3; D = 17; D = 32 in bf16), the direct configuration elsewhere (D =
#: 32 in f32).
REPROJECT_WIDE = ["48kHz", "44kHz4096", "hop2.86ms", "hop1.55ms"]


def check_reproject(dev):
    """B1 against its plain version, bit for bit (the kernel adds the same
    f32 terms in the same order, rounds once at the same point and copies
    the mirror runs after it: rounding and copying commute): the split
    iteration's shapes (32 x 800; bf16, the default loop, and f32, the f32
    loop on the card) and `REPROJECT_SIDE`, both types each, the lanes
    beyond the window support holding noise that the kernel must ignore.
    One CUDA kernel a call and nothing else (torch.profiler), no spill; the
    kernel's and the wrapper's times and the host's time a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from sstts_torch.config import Config
    from sstts_torch.dsp import reproject as rp

    def inputs(ds, Bt, T, dt, seed):
        length = (T - 1) * ds.hop_len
        geom = (ds.n_fft, ds.hop_len, ds.win_len, length)
        plan = rp.band_plan(*geom[:3], T, length)
        wp = -(-plan["w_len"] // 128) * 128
        g = torch.Generator().manual_seed(seed)
        frames = torch.randn(Bt, T, wp, generator=g).to(dev, dt)
        return frames, geom, plan, rp.padded_wss2d(plan, wp, dev)

    checks = []
    lib = rp.library()
    main = {}
    wide = {tag: fields for tag, fields, *_ in GL_SIDE_GEOMETRIES if tag in REPROJECT_WIDE}
    cases = ([("32x800", {}, 32, 800)] + REPROJECT_SIDE
             + [(tag, wide[tag], 2, 150) for tag in REPROJECT_WIDE])
    for i, (case, fields, Bt, T) in enumerate(cases):
        ds = dataclasses.replace(Config().dataset, **fields)
        for dt in (torch.bfloat16, torch.float32):
            frames, geom, plan, wss2d = inputs(ds, Bt, T, dt, 6 + i)
            n0 = rp.reproject_frames.launches
            got = rp.reproject_frames(frames, *geom, wss2d)
            ref = rp.reproject_frames_plain(frames, *geom, wss2d)
            torch.cuda.synchronize()
            launches = rp.reproject_frames.launches - n0
            equal = bool(torch.equal(got, ref))
            err, frac = max_err(got, ref), float((got != ref).float().mean())
            name = f"{case}-{str(dt).split('.')[-1]}"
            log(f"  B1 reproject_frames {name} (D {plan['d_max']}, {len(plan['runs'])} mirror "
                f"runs): bit-equal {equal} (max_abs_err {err:.3e}, differing {frac:.2e}), "
                f"{launches} launch")
            if not (equal and launches == 1):
                raise AssertionError(f"reproject_frames {name}: equal {equal}, {launches}")
            checks.append({"case": name, "max_abs_err": err, "tol": 0.0, "bit_equal": equal})
            if case == "32x800":
                main[dt] = (frames, geom, plan, wss2d)
    # One call launches one kernel and nothing else on the card: no torch
    # op for the mirror runs, the run table and the ring made once.
    frames, geom, plan, wss2d = main[torch.bfloat16]
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        rp.reproject_frames(frames, *geom, wss2d)
        torch.cuda.synchronize()
    on_card = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    log(f"  B1 one reproject_frames call on the card: {on_card}")
    if len(on_card) != 1 or "reproject_kernel" not in on_card[0]:
        raise AssertionError(f"reproject_frames launched {on_card}")
    ptxas = kernel_ptxas("reproject", "reproject_kernel", "reproject_kernel")
    w_len, hop, d_max = plan["w_len"], geom[1], plan["d_max"]
    times = {}
    for dt, (f, _, _, wss) in main.items():
        case = str(dt).split(".")[-1]
        times[case] = {
            "kernel": cuda_ms(lambda: rp.launch(lib, f, wss, w_len, hop, d_max, plan["runs"])),
            "wrapper": cuda_ms(lambda: rp.reproject_frames(f, *geom, wss)),
            "plain": cuda_ms(lambda: rp.reproject_frames_plain(f, *geom, wss), 2, 3),
        }
        log(f"  B1 {case} times (ms): {times[case]}")
    host_us = host_us_per_launch(lambda: rp.reproject_frames(frames, *geom, wss2d))
    # Reads the frames' and the envelope's first w_len lanes (the rest is
    # zero in the loop), writes every lane; 8 adds and a multiply per needed
    # element.
    Bt, T, wp = frames.shape
    rows = Bt * T
    n_bytes = rows * w_len * 2 + nbytes(wss2d[:, :w_len]) + rows * wp * 2
    bms, by = bound_ms(n_bytes, 9 * rows * w_len, "f32")
    ms = times["bfloat16"]["kernel"]
    log(f"  B1 {ms:.4f} ms (before the redesign {B1_MS_PREV['kernel']}, with its mirror "
        f"runs {B1_MS_PREV['with_mirror_runs']}); wrapper {times['bfloat16']['wrapper']:.4f} "
        f"ms; bound {bms:.4f}: {bms / ms:.1%} of it; host {host_us:.1f} us a call")
    # The direct configuration at the split iteration's batch: 44.1 kHz at a
    # 128-sample hop (D = 15) in f32, where no ring holds the rows.
    fields = next(f for c, f, _, _ in REPROJECT_SIDE if c == "44kHz-hop128")
    ds = dataclasses.replace(Config().dataset, **fields)
    f, g, pl, wss = inputs(ds, 32, 800, torch.float32, 9)
    dw = pl["w_len"]
    direct_ms = cuda_ms(lambda: rp.launch(lib, f, wss, dw, g[1], pl["d_max"], pl["runs"]), 3, 3)
    n_bytes = 32 * 800 * (dw * 4 + f.shape[-1] * 4) + nbytes(wss[:, :dw])
    direct_bound = bound_ms(n_bytes, (2 * pl["d_max"] + 2) * 32 * 800 * dw, "f32")
    times["direct-f32-44kHz-hop128"] = {"kernel": direct_ms, "bound_ms": direct_bound[0],
                                         "bound_by": direct_bound[1]}
    log(f"  B1 direct configuration (44.1 kHz, hop 128, D {pl['d_max']}, f32, 32 x 800): "
        f"{direct_ms:.4f} ms, bound {direct_bound[0]:.4f} ({direct_bound[1]})")
    # The geometries past n_fft 2048 and D = 16 at the split iteration's
    # batch, each in the configuration `rp.config` picks; the bound: the
    # needed lanes read once, every lane written, and 2 D + 2 operations an
    # element (the adds and the scale) at the f32 rate, whichever is larger.
    for i, tag in enumerate(REPROJECT_WIDE):
        ds = dataclasses.replace(Config().dataset, **wide[tag])
        for dt in (torch.bfloat16, torch.float32):
            f, g, pl, wss = inputs(ds, 32, 800, dt, 20 + i)
            dw, es, wpw = pl["w_len"], f.element_size(), f.shape[-1]
            ring = rp.config(lib.sstts_reproject_smem_bytes, wpw, es, pl["d_max"],
                             lib.sstts_reproject_rows())
            ms_w = cuda_ms(lambda: rp.launch(lib, f, wss, dw, g[1], pl["d_max"], pl["runs"]),
                           3, 3)
            n_bytes = 32 * 800 * (dw + wpw) * es + nbytes(wss[:, :dw])
            bw = bound_ms(n_bytes, (2 * pl["d_max"] + 2) * 32 * 800 * dw, "f32")
            name = f"{tag}-{str(dt).split('.')[-1]}"
            times[name] = {"kernel": ms_w, "config": "ring" if ring else "direct",
                           "d_max": pl["d_max"], "wp": wpw, "bound_ms": bw[0],
                           "bound_by": bw[1]}
            log(f"  B1 {name} ({times[name]['config']}, w_len {dw} in {wpw}, D {pl['d_max']}, "
                f"32 x 800): {ms_w:.4f} ms, bound {bw[0]:.4f} ({bw[1]}; {bw[0] / ms_w:.1%})")
            del f, wss
    # Past its envelope (D > 256) the wrapper refuses before any launch.
    for fields, kernels, dt in GL_REFUSED:
        if "B1" not in kernels:
            continue
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dt]
        ds = dataclasses.replace(Config().dataset, **fields)
        f, g, pl, wss = inputs(ds, 2, 70, dtype, 90)
        n0 = rp.reproject_frames.launches
        try:
            rp.reproject_frames(f, *g, wss)
        except NotImplementedError as e:
            log(f"  B1 refuses {fields} {dt} (w_len {pl['w_len']}, D {pl['d_max']}): "
                f"{str(e)[:60]}...")
        else:
            raise AssertionError(f"reproject_frames took {fields} {dt}, D {pl['d_max']}")
        if rp.reproject_frames.launches != n0:
            raise AssertionError("reproject_frames counted a launch it refused")
    return {
        "name": "reproject_frames_pallas", "route": "cuda",
        "source": "sstts_torch/csrc/reproject.cu",
        "replaces": "sstts/dsp/reproject.py:207",
        "max_abs_err": checks[0]["max_abs_err"],
        "ms": ms, "plain_ms": times["bfloat16"]["plain"],
        "bound_ms": bms, "bound_by": by, "library_ms": None,
        "ms_wrapper": times["bfloat16"]["wrapper"],
        "ms_f32": times["float32"]["kernel"], "times": times,
        "host_us_per_call": host_us, "ptxas": ptxas,
        "shape": [Bt, T, wp], "checks": checks,
    }


def check_gl_fused(dev):
    """B5 against its function (`b5_reference`: the plain version with
    GEMM1's sums exact) at the synthesis path's shapes, bf16: the kernel's
    own function, and the whole iteration with the edge repair (the same
    torch code on both sides)."""
    import torch

    from sstts_torch.dsp import gl_fused as gl
    from sstts_torch.dsp.gl_tiles import k_major

    from sstts_torch.synthesize import exact_f32

    checks = []

    def compare(Bt, T, seed, ds=None, tag="", dtype=torch.bfloat16):
        x = gl_inputs(dev, Bt, T, seed, ds, dtype)
        ds, plan, hp = x["ds"], x["plan"], x["hp"]
        w_len, d_max, hop = plan["w_len"], plan["d_max"], ds.hop_len
        q, mag2, w_inv, w_fwd, wss2d = (x[k] for k in ("q", "mag2", "w_inv", "w_fwd",
                                                       "wss2d"))
        core = (q, mag2, w_inv, w_fwd, wss2d, w_len, hop, d_max)
        whole_args = (q, mag2, w_inv, w_fwd, ds.n_fft, hop, ds.win_len, x["length"], wss2d)
        got = gl.gl_iteration(*core)
        whole = gl.fused_gl_iteration(*whole_args)
        with exact_f32(dev):
            ref = b5_reference(*core)
            whole_ref, _ = gl._patch_edges(
                ref.clone(), None,
                lambda lo, hi: (gl._edge_frames(q, w_inv, w_len, hop, d_max, lo, hi)
                                * wss2d[lo:hi]),
                mag2, w_fwd, plan, T, hp,
            )
        torch.cuda.synchronize()
        for case, a, b in (("kernel", got, ref), ("with-edge-repair", whole, whole_ref)):
            if (Bt, T) != (32, 800):
                case += f"-{Bt}x{T}{tag}"
            checks.append(hold_gl("B5", case, a, b))
        return x, core, whole_args

    x, core, whole_args = compare(32, 800, 7)
    for i, (Bt, T) in enumerate(GL_SIDE_SHAPES):
        compare(Bt, T, 70 + i)
    for i, (ds, tag, dtype) in enumerate(gl_side_geometries("B5")):
        compare(3, 150, 80 + i, ds, "-" + tag, dtype)
    gl_refusals("B5", dev, gl.gl_iteration, lambda x: (
        x["q"], x["mag2"], x["w_inv"], x["w_fwd"], x["wss2d"], x["plan"]["w_len"],
        x["ds"].hop_len, x["plan"]["d_max"]))
    ptxas = kernel_ptxas("gl_fused", "gl_fused_kernel", "gl_fused_kernel")
    ptxas.update(kernel_ptxas("gl_fused", "gl_fused_wide_kernel", "\0"))
    kt = (k_major(x["w_inv"]), k_major(x["w_fwd"]))  # the loop makes them once
    ms = cuda_ms(lambda: gl.gl_iteration(*core, *kt), 3, 5)
    plain = cuda_ms(lambda: gl.gl_iteration_plain(*core), 1, 3)
    ms_whole = cuda_ms(lambda: gl.fused_gl_iteration(*whole_args, *kt), 3, 5)
    host_us = host_us_per_launch(lambda: gl.gl_iteration(*core, *kt), 100)
    host_us_whole = host_us_per_launch(
        lambda: gl.fused_gl_iteration(*whole_args, *kt), 100)
    Bt, T, wp, hp, w_len = 32, 800, x["wp"], x["hp"], x["plan"]["w_len"]
    # Both GEMMs need only the first w_len synthesis lanes (w_inv's columns,
    # w_fwd's rows and the envelope are zero beyond them).
    rows = Bt * T
    n_bytes = (nbytes(x["q"], x["mag2"], x["w_inv"][:, :w_len], x["w_fwd"][:w_len],
                      x["wss2d"][:, :w_len]) + rows * 2 * hp * 2)
    bms, by = bound_ms(n_bytes, 2 * 2 * rows * w_len * 2 * hp, "bf16")
    log(f"  B5 times: {ms:.4f} ms (before the redesign "
        f"{GL_MS_PREV['fused_gl_iteration']}), with its edge repair {ms_whole:.4f}; "
        f"bound {bms:.4f}: {bms / ms:.1%} of it; host {host_us:.1f} us a launch, "
        f"{host_us_whole:.1f} us with the edge repair")
    by_geometry = gl_geometry_times(dev, "B5")
    split_f32 = split_f32_ms(dev)
    return {
        "name": "fused_gl_iteration", "route": "cuda",
        "source": "sstts_torch/csrc/gl_fused.cu",
        "replaces": "sstts/dsp/gl_fused.py:491",
        "max_abs_err": checks[0]["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "ms_with_edge_repair": ms_whole,
        "host_us_per_launch": host_us, "host_us_with_edge_repair": host_us_whole,
        "ptxas": ptxas, "shape": [Bt, T, wp, 2 * hp], "checks": checks,
        "ms_f32": by_geometry["defaults-f32"]["ms"], "by_geometry": by_geometry,
        "split_f32_iteration_ms": split_f32,
    }


def split_f32_ms(dev) -> float:
    """For context beside the f32 kernels: one "split" iteration of the f32
    loop on the card at the default geometry (32 x 800, 2 hp = 2304):
    cuBLAS's f32 GEMM1, B1 in f32, cuBLAS's f32 GEMM2 and the renorm in
    torch, under full f32 (TF32 off)."""
    import torch

    from sstts_torch.dsp.gl_fused import renorm
    from sstts_torch.dsp.reproject import reproject

    x = gl_inputs(dev, 32, 800, 4, None, torch.float32, on_card=True)
    ds = x["ds"]
    geom = (ds.n_fft, ds.hop_len, ds.win_len, x["length"])

    def iteration():
        frames = reproject(x["q"] @ x["w_inv"], *geom, wss2d=x["wss2d"])
        return renorm(frames @ x["w_fwd"], x["mag2"], x["hp"], torch.float32)

    ms = cuda_ms(iteration, 3, 3)
    log(f"  split f32 iteration (GEMM1, B1, GEMM2, renorm; 32 x 800, 2 hp "
        f"{2 * x['hp']}): {ms:.4f} ms")
    return ms


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

    from sstts_torch.config import with_fast_vocoder
    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.synthesize import Synthesizer

    cfg = bench_config()
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
    expected = dict.fromkeys(launches, 0)
    expected.update({"gru_sequence": 4, "fused_decode": 1, "fused_reproject_analyze": 60})
    log(f"  main path launches: {launches} (expected {expected}); decode routes "
        f"{synth.decode_routes}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    if set(synth.decode_routes.values()) != {"fused"}:
        raise AssertionError(f"decode routes {synth.decode_routes}: not the kernel")
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
    # CPU (their plain versions).
    result["tiny_card_vs_cpu_rel_l2"] = tiny_card_vs_cpu(tiny_cfg())

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
    ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])
    # The 12 largest rows, and the GRU kernels' wherever they rank.
    for rank, (name, (us, n)) in enumerate(ranked):
        if rank < 12 or "gru_" in name:
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


# --------------------------------------------------------------- phase 3c --

#: bench.py's serving candidates (bench.py:205-218) that this phase drives:
#: (iteration, wire, iterations, momentum, the Griffin-Lim kernel and its
#: launches per batch).  Every batch also launches B3 4 times and B4 once.
SERVING = [
    ("fused", "pcm16", 60, 0.0, "fused_gl_iteration", 60),
    ("split", "pcm16", 60, 0.0, "reproject_frames_pallas", 60),
    ("split", "adpcm3", 25, 0.99, "reproject_frames_pallas", 25),
    ("semi", "adpcm3", 25, 0.99, "fused_reproject_analyze", 25),
    ("semi", "adpcm4", 30, 0.99, "fused_reproject_analyze", 30),
    ("semi", "mulaw8", 30, 0.99, "fused_reproject_analyze", 30),
]


def bench_config():
    """bench.py's workload at the default Config(): 160 decoder steps of
    r=5 (800 frames), stop threshold 1.1 so every row runs to full length."""
    from sstts_torch.config import Config

    cfg = Config()
    return cfg.replace(
        inference=dataclasses.replace(
            cfg.inference, max_decoder_steps=160, stop_threshold=1.1,
            griffin_lim_iters=60,
        )
    )


def with_inference(cfg, **fields):
    return cfg.replace(inference=dataclasses.replace(cfg.inference, **fields))


def serving_path(dev, card):
    """Each serving candidate: one warm-up batch, then `synthesize_stream`
    over 4 batches at depth 2 with the counters set to 0 just before and
    read just after; then the wire encoders card against CPU, a stream
    yield against `synthesize_batch`, the tiny config card against CPU for
    split (bf16 and f32 loops) and fused, the f32 loop card against CPU,
    long-form and `to_file`."""
    import numpy as np
    import torch

    from sstts_torch.data.wav import load_wav
    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.ops import kernel_wrappers
    from sstts_torch.synthesize import Synthesizer

    cfg = bench_config()
    ds = cfg.dataset
    params = init_state_dict(cfg.arch, cfg.dataset, seed=0)
    texts = ["the quick brown fox jumps over the lazy dog " * 2] * 32
    frames = cfg.inference.max_decoder_steps * cfg.arch.reduction_factor
    n_batches, n_expected = 4, (frames - 1) * ds.hop_len
    audio_s = 32 * n_expected / ds.sample_rate
    result = {"candidates": []}
    totals = dict.fromkeys(kernel_wrappers(), 0)
    for impl, wire, iters, momentum, kernel, per_batch in SERVING:
        name = f"{impl}-{iters}@{momentum}/{wire}"
        synth = Synthesizer(with_inference(
            cfg, griffin_lim_iter_impl=impl, wire_format=wire,
            griffin_lim_iters=iters, griffin_lim_momentum=momentum,
        ), params, seed=0)
        synth.synthesize_batch(texts)  # warm-up
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = list(synth.synthesize_stream([texts] * n_batches, depth=2))
        wall = time.perf_counter() - t0
        launches = counts()
        expected = dict.fromkeys(launches, 0)
        expected.update({"gru_sequence": 4 * n_batches, "fused_decode": n_batches,
                         kernel: per_batch * n_batches})
        batch_s = wall / n_batches
        log(f"  {name}: {n_batches} batches in {wall:.4f} s, {batch_s:.4f} s a batch, "
            f"{audio_s / batch_s:.2f} s audio / wall s; launches {launches} [{card}]")
        if launches != expected:
            raise AssertionError(f"{name}: launches {launches} != {expected}")
        for wavs in outs:
            if len(wavs) != 32 or any(
                w.shape != (n_expected,) or not np.isfinite(w).all() for w in wavs
            ):
                raise AssertionError(f"{name}: waveforms {[w.shape for w in wavs]}")
        for k, v in launches.items():
            totals[k] += v
        result["candidates"].append({"name": name, "batch_s": batch_s,
                                     "rtf_x": audio_s / batch_s, "launches": launches})
        if impl in ("fused", "split") and iters == 60:
            result[f"profile_{impl}"] = profile(lambda: synth.synthesize_batch(texts), card)
    result["launches"] = totals

    # 1. The wire encoders on the card and on the CPU over the same f32
    # audio (a synthesized batch and a seeded harmonic mix): equal bytes.
    from sstts_torch.dsp import ops as dsp_ops

    _, full = Synthesizer(cfg, params, seed=1).synthesize_batch(
        texts, full_output=True, fetch=("wav", "n_samples"))
    rng = np.random.default_rng(8)
    tt = np.arange(n_expected) / ds.sample_rate
    mix = (0.5 * np.sin(2 * np.pi * 220 * tt) + 0.2 * np.sin(2 * np.pi * 730 * tt)
           + 0.02 * rng.standard_normal((32, n_expected)))
    enc_ms = {}
    for label, audio in (("synthesized", full["wav"]), ("harmonic", mix)):
        x = torch.as_tensor(np.asarray(audio, np.float32))
        xd = x.to(dev)
        for fmt in dsp_ops.WIRE_FORMATS:
            on_card = dsp_ops.encode_wire(xd, fmt).cpu().numpy()
            on_cpu = dsp_ops.encode_wire(x, fmt).numpy()
            if not np.array_equal(on_card, on_cpu):
                raise AssertionError(
                    f"{fmt} wire on {label} audio: {int((on_card != on_cpu).sum())} "
                    f"of {on_cpu.size} bytes differ between card and CPU")
            if label == "synthesized":
                enc_ms[fmt] = cuda_ms(lambda: dsp_ops.encode_wire(xd, fmt), 2, 3)
        log(f"  wire encoders on {label} audio (32 x {n_expected}): card bytes == CPU "
            f"bytes for {list(dsp_ops.WIRE_FORMATS)}")
    log(f"  wire encode ms on the card (32 x {n_expected}): {enc_ms} [{card}]")
    result["encode_ms"] = enc_ms

    # 2. A stream yield equals synthesize_batch (same seed, same dropout
    # draws, the same kernels on the same card).
    mcfg = with_inference(cfg, griffin_lim_iters=30, griffin_lim_momentum=0.99,
                          wire_format="mulaw8")
    streamed = list(Synthesizer(mcfg, params, seed=2).synthesize_stream([texts] * 2))
    single = Synthesizer(mcfg, params, seed=2)
    for got in streamed:
        want = single.synthesize_batch(texts)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("a stream yield differs from synthesize_batch")
    log("  stream yields == synthesize_batch (2 batches, mulaw8, GL-30@0.99)")

    # 3. The tiny config on the card (kernels B1, B5) against the CPU
    # (their plain versions), as phase 3 holds the semi iteration; "split"
    # also with the f32 loop, which the card runs through "split".
    tiny = {
        impl: tiny_card_vs_cpu(with_inference(tiny_cfg(), griffin_lim_iter_impl=impl))
        for impl in ("split", "fused")
    }
    tiny["split-dft_high"] = tiny_card_vs_cpu(with_inference(
        tiny_cfg(), griffin_lim_iter_impl="split", griffin_lim_fft_impl="dft_high"))
    result["tiny_card_vs_cpu_rel_l2"] = tiny
    result["f32_loop_card_vs_cpu_rel_l2"] = check_f32_loop(dev)

    # 4. Long-form: a 3-sentence paragraph, one sentence a chunk (at most
    # 60 characters each), as one batch padded to 4.
    paragraph = ("The quick brown fox jumps over the lazy dog. A second sentence "
                 "follows it here. And a third one ends the paragraph.")
    synth = Synthesizer(cfg, params, seed=3)
    t0 = time.perf_counter()
    long_wav = synth.synthesize_longform(paragraph, max_chars=60)
    long_s = time.perf_counter() - t0
    gap = int(ds.sample_rate * 0.12)
    if long_wav.shape != (3 * n_expected + 2 * gap,) or not np.isfinite(long_wav).all():
        raise AssertionError(f"long-form: {long_wav.shape}")
    log(f"  long-form: 3 chunks, {long_wav.shape[0]} samples in {long_s:.3f} s [{card}]")

    # 5. to_file, read back (dropout off: the same audio twice).
    quiet = Synthesizer(cfg.replace(arch=dataclasses.replace(
        cfg.arch, prenet_dropout_at_inference=False)), params)
    path = quiet.to_file(texts[0], Path(__file__).resolve().parent / "chip_scratch" / "smoke.wav")
    samples, sr = load_wav(path)
    want = quiet.synthesize(texts[0])
    err = float(np.abs(samples - want).max())
    log(f"  to_file: {path.name}, {samples.shape[0]} samples at {sr} Hz, max diff from "
        f"synthesize {err:.2e} (PCM16 read back at 1/32768: tol 1e-4)")
    if sr != ds.sample_rate or samples.shape != want.shape or not err <= 1e-4:
        raise AssertionError(f"to_file: {sr}, {samples.shape}, {err}")
    return result


#: The f32 loop's iterations `check_f32_loop` runs, as (iteration, momenta,
#: the kernel it launches once an iteration).
F32_LOOP_ITERS = [
    ("split", (0.0, 0.99), "reproject_frames_pallas"),
    ("semi", (0.0, 0.99), "fused_reproject_analyze"),
    ("fused", (0.0,), "fused_gl_iteration"),
]


def check_f32_loop(dev) -> dict:
    """The f32 Griffin-Lim loop (dft_high and dft_highest) on the card
    against the CPU on one magnitude: the default geometry, 2 x 120 frames
    of a seeded harmonic mix, 8 iterations.  "split" (cuBLAS f32 GEMMs, B1
    in f32, the renorm in torch) classic and at momentum 0.99, "semi" (B2's
    f32 variant) classic and at momentum 0.99, "fused" (B5's) classic; the
    CPU runs the same iterations through the plain versions (exact f32
    products)."""
    import numpy as np
    import torch

    from sstts_torch.config import Config
    from sstts_torch.dsp import stft as stft_mod
    from sstts_torch.dsp.griffin_lim import griffin_lim
    from sstts_torch.synthesize import exact_f32

    ds = Config().dataset
    T, n_iters = 120, 8
    length = (T - 1) * ds.hop_len
    rng = np.random.default_rng(10)
    tt = np.arange(length) / ds.sample_rate
    y = (0.5 * np.sin(2 * np.pi * 220 * tt) + 0.2 * np.sin(2 * np.pi * 730 * tt)
         + 0.02 * rng.standard_normal((2, length)))
    mag = stft_mod.stft(torch.as_tensor(y, dtype=torch.float32), ds.n_fft, ds.hop_len,
                        ds.win_len).abs()[..., :T, :].contiguous()
    # Both sides are f32 with sums in other orders; Griffin-Lim carries a
    # last-place difference through its iterations and turns it into a
    # phase change at near-silent bins, so the waveforms are held to 5e-3
    # relative L2, far below the distance between the bf16 and the f32
    # loops on such noisy input.
    tol, out = 5e-3, {}
    for impl, momenta, kernel in F32_LOOP_ITERS:
        for fft_impl in ("dft_high", "dft_highest"):
            for m in momenta:
                args = (ds.n_fft, ds.hop_len, ds.win_len, n_iters, length)
                kw = {"momentum": m, "fft_impl": fft_impl, "iter_impl": impl}
                reset()
                with torch.no_grad(), exact_f32(dev):
                    on_card = griffin_lim(mag.to(dev), *args, **kw).cpu()
                torch.cuda.synchronize()
                launches = counts()
                with torch.no_grad():
                    on_cpu = griffin_lim(mag, *args, **kw)
                rel = float((on_card - on_cpu).norm() / on_cpu.norm())
                case = f"{fft_impl}@{m}" if impl == "split" else f"{impl}-{fft_impl}@{m}"
                log(f"  f32 loop ({impl}, {fft_impl}@{m}) card vs CPU: wav rel L2 {rel:.3e} "
                    f"(tol {tol}); {kernel} launches {launches[kernel]} (expected {n_iters})")
                if not (rel < tol and launches[kernel] == n_iters
                        and sum(launches.values()) == n_iters
                        and torch.isfinite(on_card).all()):
                    raise AssertionError(f"f32 loop {impl} {case}: rel {rel}, launches {launches}")
                out[case] = rel
    return out


def tiny_cfg():
    """The tiny config, deterministic (dropout off), with the fused
    decoder's bf16 products and the bf16 Griffin-Lim loop."""
    from sstts_torch.config import tiny_config

    tcfg = tiny_config()
    return tcfg.replace(
        arch=dataclasses.replace(tcfg.arch, prenet_dropout_at_inference=False),
        inference=dataclasses.replace(
            tcfg.inference, decoder_impl="fused", stop_threshold=1.1,
            max_decoder_steps=24, griffin_lim_iters=8,
        ),
    )


def tiny_card_vs_cpu(tcfg) -> float:
    """The tiny config's batch on the card (kernels) against the CPU (their
    plain versions): equal lengths, and relative L2 under 5e-2 with the
    bf16 Griffin-Lim loop, whose roundings set the error (the mels agree to
    about 1e-7), and under 5e-3 with the f32 loop (as `check_f32_loop`)."""
    import numpy as np

    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.synthesize import Synthesizer

    tparams = init_state_dict(tcfg.arch, tcfg.dataset, seed=1)
    small = ["the quick brown fox", "jumps over the lazy dog twice"]
    _, on_card = Synthesizer(tcfg, tparams).synthesize_batch(small, full_output=True)
    _, on_cpu = Synthesizer(tcfg, tparams, device="cpu").synthesize_batch(
        small, full_output=True
    )
    rel = float(np.linalg.norm(on_card["wav"] - on_cpu["wav"])
                / np.linalg.norm(on_cpu["wav"]))
    mel_err = float(np.abs(on_card["mel"] - on_cpu["mel"]).max())
    fft_impl = tcfg.inference.griffin_lim_fft_impl or "dft_default"
    impl = f"{tcfg.inference.griffin_lim_iter_impl or 'auto'}, {fft_impl}"
    tol = 5e-2 if fft_impl == "dft_default" else 5e-3
    log(f"  tiny config card vs CPU plain ({impl}): n_frames "
        f"{on_card['n_frames'].tolist()} vs {on_cpu['n_frames'].tolist()}, mel "
        f"max_abs_err {mel_err:.3e}, wav rel L2 {rel:.3e} (tol {tol})")
    if not (np.array_equal(on_card["n_samples"], on_cpu["n_samples"]) and rel < tol):
        raise AssertionError(f"tiny card vs CPU ({impl}): rel {rel}")
    return rel


# --------------------------------------------------------------- phase 3h --

#: Phase 3h's cases, as (case, DatasetConfig fields, InferenceConfig fields):
#: the settings the Griffin-Lim kernels took only through "split" before their
#: wide configuration: a 24 kHz corpus at 50 / 12.5 ms, 44.1 kHz at n_fft 2048
#: (a 2048-sample window, a 512-sample hop) and the f32 loop at the defaults;
#: and 48 kHz at n_fft 4096 and 50 / 12.5 ms (a 2400-sample window, a
#: 600-sample hop: 10 s of audio an utterance), which they refused before
#: they lost their lane cap.
GEOMETRY_CASES = [
    ("24kHz", DS_24K, {}),
    ("44kHz", DS_44K, {}),
    ("dft_highest", {}, {"griffin_lim_fft_impl": "dft_highest"}),
    ("48kHz", DS_48K, {}),
]

#: Phase 3h's fused-60 runs (B5), as (case of GEOMETRY_CASES, batches through
#: `synthesize_stream` at depth 2).
GEOMETRY_FUSED = [("24kHz", 2), ("48kHz", 1)]

#: Phase 3h holds each case's audio at the default iteration ("semi": B2)
#: to the same batch through "split" (B1) on the card, the prenet's dropout
#: off so that both vocode one linear spectrogram: relative L2 of the two
#: waveforms' STFT magnitudes (and fused-60's at 24 kHz likewise).  The
#: iterations round at other points (bf16 "split" rounds the spectrum before
#: the renorm, "semi" does not, "fused" keeps GEMM1's frames f32; f32 "semi"
#: takes three tf32 products), and 60 Griffin-Lim iterations carry that into
#: the phases, so the waveforms themselves are printed but not held.  The
#: magnitudes are pulled towards the target whatever the phases, so in bf16
#: this floor (1.41e-2 to 1.92e-2 on an H100) hides small faults: B2 without
#: its outermost halo row a side read 1.84e-2 at 24 kHz, without the edge
#: repair 1.65e-2 (PERF.md §6).  The kernel is therefore held inside the
#: path by one recorded launch against its plain version (`hold_recorded`),
#: and the limits lie between the floor and a control run that must read
#: above them: B2 without its `GEOMETRY_CONTROL_ROWS` outermost halo rows a
#: side (6.0e-2 and more in bf16, 9.7e-3 in f32), whose recorded launch the
#: same in-path check must refuse.
GEOMETRY_MAG_TOL = {"bf16": 3e-2, "f32": 1e-4}
GEOMETRY_CONTROL_ROWS = 2

#: The position of d_max among the arguments of the launch functions of
#: `sstts_torch.dsp.gl_fused` that `gl_launch_spy` watches.
_D_MAX_ARG = {"_kernel": 6, "_fused_kernel": 7}


@contextlib.contextmanager
def gl_launch_spy(name: str, at: int = -1, drop_rows: int = 0):
    """Within the block, every call of `gl_fused.<name>` (`_kernel`, B2's
    launch, or `_fused_kernel`, B5's; the counting wrappers above them stay
    as they are) goes through a spy.  The `at`-th call's arguments and
    output are kept as clones in the yielded dict ("args", "out").  With
    `drop_rows` each launch takes d_max - drop_rows, a fault for phase 3h's
    control; the arguments kept are the true ones."""
    import torch

    from sstts_torch.dsp import gl_fused

    def clone(v):
        if isinstance(v, (tuple, list)):
            return tuple(clone(u) for u in v)
        return v.clone() if isinstance(v, torch.Tensor) else v

    orig = getattr(gl_fused, name)
    seen = {"calls": 0}

    def spy(*args):
        launch_args = list(args)
        launch_args[_D_MAX_ARG[name]] -= drop_rows
        out = orig(*launch_args)
        if seen["calls"] == at:
            seen["args"], seen["out"] = clone(args), clone(out)
        seen["calls"] += 1
        return out

    setattr(gl_fused, name, spy)
    try:
        yield seen
    finally:
        setattr(gl_fused, name, orig)


def hold_recorded(kernel: str, seen: dict, case: str, dev) -> list:
    """The launch `gl_launch_spy` kept (B2's `_kernel` or B5's
    `_fused_kernel`) against its plain version on the same inputs
    (`hold_gl`)."""
    from sstts_torch.dsp import gl_fused as gl
    from sstts_torch.synthesize import exact_f32

    args, out = seen["args"], seen["out"]
    with exact_f32(dev):
        if kernel == "B2":
            ref = gl.reproject_analyze_plain(*args[:9])
            pairs = [("q", out[0], ref[0]), ("s", out[1], ref[1])]
        else:
            ref = b5_reference(*args[:8])
            pairs = [("q", out, ref)]
            # For the record: the plain version (GEMM1 in cuBLAS's f32
            # order) against the kernel and against the exact sums.
            plain = gl.gl_iteration_plain(*args[:8])
            log(f"  B5 in-path-{case}: the plain version's f32 GEMM1 against the exact "
                f"sums: differing {float((plain != ref).float().mean()):.2e}; the kernel "
                f"against the plain version: differing {float((out != plain).float().mean()):.2e}")
    return [hold_gl(kernel, f"in-path-{case}-{n}", a, b) for n, a, b in pairs
            if a is not None]


def stft_mag_rel(a, b, ds) -> float:
    """Relative L2 of the STFT magnitudes of two batches of waveforms."""
    import numpy as np
    import torch

    from sstts_torch.dsp import stft as stft_mod

    def mag(w):
        y = torch.as_tensor(np.stack(w).astype(np.float32))
        return stft_mod.stft(y, ds.n_fft, ds.hop_len, ds.win_len).abs()

    ma, mb = mag(a), mag(b)
    return float((ma - mb).norm() / mb.norm())


def geometry_path(dev, card):
    """Phase 3h: bench.py's batch (32 x the 88-character text, 160 decoder
    steps, GL-60, PCM16) through `Synthesizer` at the default iteration in
    each of `GEOMETRY_CASES`: a warm-up batch, then a timed one with the
    counters set to 0 just before and read just after (B3 4, B4 1, B2 60:
    no NotImplementedError); the same batch with the prenet's dropout off
    at "auto" and at "split" against each other and against the control
    (`GEOMETRY_MAG_TOL`), its 31st B2 launch held to the plain version (and
    the control's refused by the same check); and
    the serving path's fused-60 at each of `GEOMETRY_FUSED` through
    `synthesize_stream` (at depth 2: B5 60 a batch), then with the dropout
    off against the case's "split" batch, its 31st B5 launch held
    likewise."""
    import numpy as np
    import torch

    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.ops import kernel_wrappers
    from sstts_torch.synthesize import Synthesizer

    texts = ["the quick brown fox jumps over the lazy dog " * 2] * 32
    result = {"cases": {}}
    splits = {}
    totals = dict.fromkeys(kernel_wrappers(), 0)

    def counted(fn, expected_extra, what):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t0
        launches = counts()
        expected = dict.fromkeys(launches, 0)
        expected.update(expected_extra)
        if launches != expected:
            raise AssertionError(f"{what}: launches {launches} != {expected}")
        for k, v in launches.items():
            totals[k] += v
        return out, wall, launches

    def vocode(c, params, spy=None, **how):
        """The batch's f32 waveforms before the wire under config `c`, seed 1
        (a random init's audio is ~1e-5, below PCM16's step), through
        `gl_launch_spy(spy, **how)` if named: (waveforms, what it kept)."""
        synth = Synthesizer(c, params, seed=1)
        with gl_launch_spy(spy, **how) if spy else contextlib.nullcontext({}) as seen:
            wavs, _ = synth.synthesize_batch(texts, full_output=True,
                                             fetch=("wav", "n_samples"))
        return wavs, seen

    for case, ds_fields, inf_fields in GEOMETRY_CASES:
        base = bench_config()
        cfg = with_inference(base.replace(dataset=dataclasses.replace(
            base.dataset, **ds_fields)), **inf_fields)
        ds = cfg.dataset
        dtype = "f32" if inf_fields else "bf16"
        params = init_state_dict(cfg.arch, ds, seed=0)
        synth = Synthesizer(cfg, params, seed=0)
        synth.synthesize_batch(texts)  # warm-up
        wavs, wall, launches = counted(
            lambda: synth.synthesize_batch(texts),
            {"gru_sequence": 4, "fused_decode": 1, "fused_reproject_analyze": 60}, case)
        frames = cfg.inference.max_decoder_steps * cfg.arch.reduction_factor
        n_expected = (frames - 1) * ds.hop_len
        if any(w.shape != (n_expected,) or not np.isfinite(w).all() for w in wavs):
            raise AssertionError(f"{case}: waveforms {[w.shape for w in wavs]}")
        audio_s = 32 * n_expected / ds.sample_rate
        quiet = cfg.replace(arch=dataclasses.replace(cfg.arch,
                                                     prenet_dropout_at_inference=False))
        auto, seen = vocode(quiet, params, "_kernel", at=30)
        checks = hold_recorded("B2", seen, case, dev)
        split, _ = vocode(with_inference(quiet, griffin_lim_iter_impl="split"), params)
        halo, seen = vocode(quiet, params, "_kernel", at=30, drop_rows=GEOMETRY_CONTROL_ROWS)
        try:
            hold_recorded("B2", seen, f"{case}-control", dev)
        except AssertionError:
            log(f"  {case}: the in-path check refuses the control's launch, as it must")
        else:
            raise AssertionError(f"{case}: the in-path check took the control's launch")
        splits[case] = (quiet, params, split)
        mag_rel = stft_mag_rel(auto, split, ds)
        control = stft_mag_rel(halo, split, ds)
        wav_rel = float(np.linalg.norm(np.stack(auto) - np.stack(split))
                        / np.linalg.norm(np.stack(split)))
        tol = GEOMETRY_MAG_TOL[dtype]
        log(f"  {case} (sample rate {ds.sample_rate}, n_fft {ds.n_fft}, window {ds.win_len}, "
            f"hop {ds.hop_len}, {dtype} loop): batch wall {wall:.4f} s, {audio_s:.2f} s of "
            f"audio, {audio_s / wall:.2f} s audio / wall s; launches {launches}; 'auto' vs "
            f"'split' STFT-magnitude rel L2 {mag_rel:.3e} (tol {tol}; the control, B2 at "
            f"d_max - {GEOMETRY_CONTROL_ROWS}: {control:.3e}), waveform rel L2 {wav_rel:.3e} "
            f"[{card}]")
        if not mag_rel <= tol < control:
            raise AssertionError(f"{case}: auto vs split {mag_rel}, control {control}, tol {tol}")
        result["cases"][case] = {"wall_s": wall, "audio_s": audio_s, "launches": launches,
                                 "auto_vs_split_mag_rel_l2": mag_rel,
                                 "control_vs_split_mag_rel_l2": control,
                                 "auto_vs_split_wav_rel_l2": wav_rel, "checks": checks}

    for case, n_batches in GEOMETRY_FUSED:
        ds_fields = next(f for c, f, _ in GEOMETRY_CASES if c == case)
        base = bench_config()
        cfg = with_inference(base.replace(dataset=dataclasses.replace(base.dataset,
                                                                      **ds_fields)),
                             griffin_lim_iter_impl="fused")
        params = init_state_dict(cfg.arch, cfg.dataset, seed=0)
        synth = Synthesizer(cfg, params, seed=0)
        synth.synthesize_batch(texts)  # warm-up
        outs, wall, launches = counted(
            lambda: list(synth.synthesize_stream([texts] * n_batches, depth=2)),
            {"gru_sequence": 4 * n_batches, "fused_decode": n_batches,
             "fused_gl_iteration": 60 * n_batches}, f"fused-60 at {case}")
        frames = cfg.inference.max_decoder_steps * cfg.arch.reduction_factor
        n_expected = (frames - 1) * cfg.dataset.hop_len
        for wavs in outs:
            if len(wavs) != 32 or any(w.shape != (n_expected,) or not np.isfinite(w).all()
                                      for w in wavs):
                raise AssertionError(f"fused-60 at {case}: {[w.shape for w in wavs]}")
        quiet, params, split = splits[case]
        fused, seen = vocode(with_inference(quiet, griffin_lim_iter_impl="fused"), params,
                             "_fused_kernel", at=30)
        checks = hold_recorded("B5", seen, f"fused-{case}", dev)
        mag_rel = stft_mag_rel(fused, split, cfg.dataset)
        tol = GEOMETRY_MAG_TOL["bf16"]
        log(f"  fused-60/pcm16 at {case}: {n_batches} batches in {wall:.4f} s, "
            f"{wall / n_batches:.4f} s a batch; launches {launches}; 'fused' vs 'split' "
            f"STFT-magnitude rel L2 {mag_rel:.3e} (tol {tol}) [{card}]")
        if not mag_rel <= tol:
            raise AssertionError(f"fused-60 at {case}: fused vs split {mag_rel} > {tol}")
        result[f"fused60_{case}"] = {"batch_s": wall / n_batches, "launches": launches,
                                     "fused_vs_split_mag_rel_l2": mag_rel, "checks": checks}
    result["speech_44kHz"] = speech_spectra_check(dev, card)
    result["launches"] = totals
    return result


def speech_spectra_check(dev, card) -> dict:
    """B2 on speech-like spectra (ROADMAP C.5): a GL-60 "semi" loop at
    momentum 0.99 on the synthetic corpus's 32 spectra at 44.1 kHz (n_fft
    2048: 2047 lanes, the wide configuration's compensated sums), every
    launch held by `hold_gl` to the exact sums (`tools/gl_speech_check.py`:
    float64 products; the plain version's own f32 GEMM2 misses them now
    and then on such spectra).  The loop is not counted: it runs outside
    the path's counted batches."""
    from sstts_torch.config import Config
    from sstts_torch.tools import gl_speech_check as speech

    base = Config()
    ds = dataclasses.replace(base.dataset, **DS_44K)
    cfg = base.replace(dataset=ds, inference=dataclasses.replace(
        base.inference, griffin_lim_iter_impl="semi", griffin_lim_momentum=0.99,
        griffin_lim_iters=60))
    lin = speech.linear_of_corpus(ds, 32, 800, dev)
    rec = speech.held_loop("B2", "speech-44kHz-semi-m0.99", lin, cfg, dev)
    n = rec["outputs"]
    log(f"  B2 on speech-like spectra at 44.1 kHz (semi-60 at 0.99): {rec['launches']} "
        f"launches, past hold_gl against exact sums {len(rec['missed_vs_exact'])}, against "
        f"the plain version {len(rec['missed'])} (the plain version against exact sums "
        f"{len(rec['plain_missed_vs_exact'])}); differing from exact sums "
        f"{rec['differing_vs_exact'] / n:.3e} (the plain version "
        f"{rec['plain_differing_vs_exact'] / n:.3e}) [{card}]")
    if rec["launches"] != 60 or rec["missed_vs_exact"] or not rec["finite"]:
        raise AssertionError(f"B2 on speech-like spectra: {rec['launches']} launches, "
                             f"missed {rec['missed_vs_exact']}, finite {rec['finite']}")
    return {k: rec[k] for k in ("launches", "missed", "missed_vs_exact",
                                "plain_missed_vs_exact", "differing_vs_exact", "outputs")}


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
    expected = dict.fromkeys(launches, 0)
    expected.update({"gru_sequence": 20, "gru_sequence_backward": 20, "fused_teacher_scan": 5})
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
    expected = dict.fromkeys(elaunch, 0)
    expected.update({"gru_sequence": 4, "fused_teacher_scan": 1})
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
    result["tiny_card_vs_cpu_rel"] = tiny_step_card_vs_cpu(tiny_config(), 1e-4)
    return result


# --------------------------------------------------------------- phase 3d --


def cli_expected(cfg, overrides, command: str, steps: int = 0) -> dict:
    """The launches one CLI command must make, from the corpus it reads:
    a train step 4 GRU forward, 4 backward, 1 teacher scan; an eval batch 4
    GRU and 1 teacher scan (train evaluates min(num_eval_batches, the eval
    split's batches) and then vocodes one eval row for its media log when
    matplotlib imports); a synthesis batch 4 GRU, 1 decode and
    griffin_lim_iters semi iterations (B2)."""
    from sstts_torch import cli
    from sstts_torch.data import pipeline
    from sstts_torch.train import load_corpus

    cfg = cli.apply_overrides(cfg, overrides)
    iters = cfg.inference.griffin_lim_iters
    n = {"gru_sequence": 0, "gru_sequence_backward": 0, "fused_teacher_scan": 0,
         "fused_decode": 0, "fused_reproject_analyze": 0}

    def add(gru=0, back=0, teacher=0, decode=0, b2=0):
        for k, v in zip(n, (gru, back, teacher, decode, b2)):
            n[k] += v

    if command == "train":
        add(4 * steps, 4 * steps, steps)
        eval_utts = load_corpus(cfg)[1]
        n_eval = min(cfg.evaluation.num_eval_batches, pipeline.Batcher(
            eval_utts, cfg).batches_per_epoch(cfg.evaluation.batch_size)) if eval_utts else 0
        add(4 * n_eval, 0, n_eval)
        try:
            import matplotlib  # noqa: F401

            add(b2=iters if n_eval else 0)
        except ImportError:
            pass
    elif command == "evaluate":
        add(4 * steps, 0, steps)  # `steps` eval batches
        add(8, 0, 0, 2, 2 * iters)  # resynthesis, then --synthesize
    elif command == "synthesize":
        add(4, 0, 0, 1, iters)
    return n


def cli_path(dev, card):
    """Phase 3d: the command line at the default `Config()` widths on
    corpora written to disk, every kernel counted per command."""
    import shutil

    import numpy as np
    import torch

    from sstts_torch import cli
    from sstts_torch.config import Config
    from sstts_torch.data.synthetic import materialize_corpus
    from sstts_torch.data.wav import load_wav

    cfg = Config()
    root = Path(__file__).resolve().parent / "chip_scratch" / "cli"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    lj = materialize_corpus(root / "lj", 96, cfg.dataset, "ljspeech", pad_s=0.25)
    css = materialize_corpus(root / "css10", 8, cfg.dataset, "css10", sample_rate=16000,
                             pad_s=0.25)
    mb = sum(f.stat().st_size for f in lj.rglob("*.wav")) / 1e6
    log(f"  corpora: 96 LJSpeech-layout utterances at {cfg.dataset.sample_rate} Hz "
        f"({mb:.1f} MB of WAV), "
        f"8 CSS10 at 16 kHz, written in {time.perf_counter() - t0:.2f} s")
    run, out = root / "run", root / "run" / cfg.inference.output_dir
    lj_sets = [f"dataset.dataset_dir={lj}", "dataset.eval_fraction=0.25",
               f"dataset.cache_dir={root / 'cache'}", "training.summary_every=1"]
    css_sets = [f"dataset.dataset_dir={css}", "dataset.dataset=css10",
                "dataset.resample_on_load=True", "dataset.eval_fraction=0.25"]
    text_file = root / "texts.txt"
    text_file.write_text("the first of three lines\nprinting reports on speech\n"
                         "a lazy dog while the quick fox jumps\n")
    # (name, argv, overrides, train steps or eval batches)
    commands = [
        ("precompute", ["precompute", "--workdir", str(run), "--features", "--stats"],
         lj_sets, 0),
        ("train", ["train", "--workdir", str(run), "--max-steps", "2"], lj_sets, 2),
        ("evaluate", ["evaluate", "--workdir", str(run), "--num-batches", "1",
                      "--synthesize", "2"], lj_sets, 1),
        ("synthesize --text", ["synthesize", "--workdir", str(run), "--text",
                               "speech from the command line", "--out",
                               str(root / "single.wav")], lj_sets, 0),
        ("synthesize --text-file", ["synthesize", "--workdir", str(run), "--text-file",
                                    str(text_file)], lj_sets, 0),
        ("synthesize --longform", ["synthesize", "--workdir", str(run), "--longform",
                                   "--text", "one sentence here. and another one! "
                                   "and a third, a little longer than the others.",
                                   "--out", str(root / "longform.wav")], lj_sets, 0),
        ("train css10", ["train", "--workdir", str(root / "run_css10"), "--max-steps", "1"],
         css_sets, 1),
    ]
    result = {"commands": {}}
    totals = None
    for name, argv, sets, steps in commands:
        want = dict.fromkeys(counts(), 0)
        want.update(cli_expected(cfg, sets, argv[0], steps))
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv + [x for o in sets for x in ("--set", o)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        log(f"  {name}: rc {rc}, wall {wall:.3f} s, launches "
            f"{ {k: v for k, v in launches.items() if v} } [{card}]")
        if rc != 0 or launches != want:
            raise AssertionError(f"{name}: rc {rc}, launches {launches} != {want}")
        result["commands"][name] = {"wall_s": wall, "launches": launches}
        totals = launches if totals is None else {k: totals[k] + v for k, v in launches.items()}
    result["launches"] = totals

    # What the commands wrote.
    wavs = sorted(out.glob("eval_*.wav")) + sorted(out.glob("synthesis_*.wav")) + [
        root / "single.wav", root / "longform.wav"]
    if len(wavs) != 7:
        raise AssertionError(f"expected 7 WAV files, found {wavs}")
    for w in wavs:
        y, sr = load_wav(w)
        if sr != cfg.dataset.sample_rate or len(y) == 0 or not np.isfinite(y).all():
            raise AssertionError(f"{w}: {len(y)} samples at {sr} Hz")
    records = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    shape = {"step", "wall_s", "prefix", "loss"}
    train_recs = [r for r in records if r["prefix"] == "train"]
    eval_recs = [r for r in records if r["prefix"] == "eval"]
    if [r["step"] for r in train_recs] != [1, 2] or len(eval_recs) != 2 or not all(
        shape <= set(r) for r in records
    ):
        raise AssertionError(f"metrics.jsonl records not in the reference shape: {records}")
    final = eval_recs[-1]
    finite = {k: final[k] for k in ("loss", "loss_mel", "loss_linear", "loss_stop",
                                    "resynthesis_mel_l1") if k in final}
    if len(finite) != 5 or not all(np.isfinite(v) for v in finite.values()):
        raise AssertionError(f"evaluate's record: {final}")
    index = json.loads((root / "cache" / "index.json").read_text())
    if len(index["audio"]) != 96 or len(index["features"]) != 96:
        raise AssertionError("the cache does not hold all 96 utterances")
    log(f"  metrics.jsonl: {len(train_recs)} train and {len(eval_recs)} eval records; "
        f"evaluate: {finite}; {len(wavs)} WAV files")
    result["evaluate"] = finite
    shutil.rmtree(root)
    return result


# --------------------------------------------------------------- phase 3e --


def corpus_config(**training):
    """The default `Config()` on the synthetic corpus (256 utterances of
    4-12 words: buckets 0 and 1), b=32, the prenets' dropout off (steps
    compared across modes draw no masks)."""
    from sstts_torch.config import Config

    cfg = Config()
    return cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, dataset="synthetic"),
        arch=dataclasses.replace(cfg.arch, prenet_dropout=0.0),
        training=dataclasses.replace(cfg.training, batch_size=32, **training),
    )


def step_launches(run, steps: int, what: str) -> dict:
    """Run `run()` with the counters set to 0 just before and read just
    after; it must launch B3 4, B3' 4 and B6 1 times a step."""
    reset()
    out = run()
    launches = counts()
    want = dict.fromkeys(launches, 0)
    want.update({"gru_sequence": 4 * steps, "gru_sequence_backward": 4 * steps,
                 "fused_teacher_scan": steps})
    if launches != want:
        raise AssertionError(f"{what}: launches {launches} != {want}")
    return out


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / abs(float(b))


def corpus_path(dev, card):
    """Phase 3e: the device-resident corpus in its three formats, the
    cached and grouped steps against the host-fed one, the direct-DFT
    features, the prefetch, the driver at "auto", at steps_per_call=4 and
    host-fed, and the refusals that must raise."""
    import itertools
    import shutil

    import numpy as np
    import torch

    from sstts_torch import train as tr
    from sstts_torch.data import pipeline
    from sstts_torch.dsp.ops import wav_to_features
    from sstts_torch.synthesize import exact_f32

    cfg = corpus_config()
    utts = tr.load_corpus(cfg)[0]
    batcher = pipeline.Batcher(utts, cfg)
    result = {"formats": {}}
    corpora = {}
    for fmt in ("pcm16", "features", "features_bf16"):
        fcfg = corpus_config(device_corpus_format=fmt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        built, reason = tr.build_device_corpus(fcfg, utts, batcher=batcher, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if built is None:
            raise AssertionError(f"{fmt}: {reason}")
        corpus, counts_ = built
        size = sum(nbytes(*rows.values()) for rows in corpus.values())
        peak = torch.cuda.max_memory_allocated() - base
        log(f"  {fmt}: {sum(counts_.values())} utterances in buckets {counts_}, "
            f"{size / 1e6:.1f} MB on the card, built in {secs:.3f} s, peak "
            f"{peak / 1e6:.1f} MB above the start [{card}]")
        corpora[fmt] = (fcfg, corpus, counts_)
        result["formats"][fmt] = {"bytes": size, "build_s": secs, "peak_bytes": peak,
                                  "counts": counts_}
    _, corpus, counts_ = corpora["pcm16"]
    bucket = 1
    if counts_.get(bucket, 0) < 32:
        raise AssertionError(f"bucket 1 holds {counts_.get(bucket)} < 32 utterances")
    rows = corpus[bucket]
    idx = np.arange(32, dtype=np.int32)
    valid = np.ones(32, np.float32)
    host = {k: v[:32].cpu().numpy() for k, v in rows.items()}

    # Steps on the same rows from the same init.
    def one_step(fmt, kind):
        fcfg, fcorpus, _ = corpora[fmt]
        state = tr.create_state(fcfg, seed=0, device=dev)
        if kind == "host":
            run = lambda: tr.make_train_step(fcfg)(state, host)  # noqa: E731
        else:
            run = lambda: tr.make_cached_train_step(fcfg)(  # noqa: E731
                state, fcorpus[bucket], idx, valid)
        m = step_launches(run, 1, f"{fmt} {kind} step")
        return {k: float(m[k]) for k in ("loss", "grad_norm")}

    host_m = one_step("pcm16", "host")
    steps = {"pcm16": one_step("pcm16", "cached"), "features": one_step("features", "cached"),
             "features_bf16": one_step("features_bf16", "cached")}
    checks = [("cached pcm16 vs host-fed", steps["pcm16"], host_m, 1e-5),
              ("features vs pcm16", steps["features"], steps["pcm16"], 1e-4),
              ("features_bf16 vs pcm16", steps["features_bf16"], steps["pcm16"], 1e-2)]
    result["steps"] = {}
    for name, got, ref, tol in checks:
        r = {k: rel(got[k], ref[k]) for k in got}
        log(f"  {name}: loss {got['loss']:.7f} vs {ref['loss']:.7f}, grad_norm "
            f"{got['grad_norm']:.6f} vs {ref['grad_norm']:.6f}: relative {r} (limit {tol})")
        if not max(r.values()) <= tol:
            raise AssertionError(f"{name}: {r} > {tol}")
        result["steps"][name] = r

    # Grouped S=4 against four cached steps, and four cached steps repeated
    # (the card's own run-to-run spread).
    gcfg = corpus_config(steps_per_call=4)
    idxs = (np.arange(128, dtype=np.int32) % counts_[bucket]).reshape(4, 32)
    valids = np.ones((4, 32), np.float32)
    valids[3, 20:] = 0.0  # an epoch tail's fill rows

    def four(kind):
        state = tr.create_state(gcfg, seed=0, device=dev)
        if kind == "grouped":
            run = lambda: tr.make_grouped_train_step(gcfg)(  # noqa: E731
                state, rows, idxs, valids)
        else:
            step = tr.make_cached_train_step(gcfg)
            run = lambda: [step(state, rows, idxs[i], valids[i])  # noqa: E731
                           for i in range(4)]
        m = step_launches(run, 4, f"{kind} x4")
        if kind != "grouped":
            m = {k: torch.stack([x[k] for x in m]) for k in m[0]}
        return {k: v.cpu() for k, v in m.items()}, [p.detach().clone() for p in
                                                    state.model.parameters()]

    # cuDNN's default convolution backward, and nn.Embedding's backward
    # above 3072 indices (b=32 x 128 characters = 4096), add by atomics:
    # two runs from one state part there, and Adam's sign flips near zero
    # gradients carry it into every parameter
    # (`sstts_torch/tools/train_determinism.py`). With PyTorch's
    # deterministic algorithms the modes must agree bit for bit.
    saved = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        gm, gp = four("grouped")
        cm, cp = four("cached")
        cm2, cp2 = four("cached")
    finally:
        torch.use_deterministic_algorithms(saved)
    if gm["loss"].shape != (4,):
        raise AssertionError(f"grouped metrics shape {gm['loss'].shape}")

    def spread(ma, pa, mb, pb):
        return {"metrics": max(float((ma[k] - mb[k]).abs().max()) for k in ma),
                "params": max(float((a - b).abs().max()) for a, b in zip(pa, pb))}

    g_vs_c, c_vs_c = spread(gm, gp, cm, cp), spread(cm, cp, cm2, cp2)
    log(f"  grouped S=4 vs 4 cached steps (deterministic algorithms): largest "
        f"differences {g_vs_c}; 4 cached steps run twice: {c_vs_c}; losses "
        f"{gm['loss'].tolist()}")
    if max(g_vs_c.values()) or max(c_vs_c.values()):
        raise AssertionError(f"not bit-equal: grouped vs cached {g_vs_c}, cached twice {c_vs_c}")
    result["grouped_vs_cached"] = g_vs_c
    result["cached_vs_cached"] = c_vs_c

    # The direct-DFT features against the default (torch.fft) on 32 rows.
    samples = rows["samples"][:32].float() * (1.0 / 32767.0)
    with torch.no_grad(), exact_f32(dev):
        ref = wav_to_features(samples, cfg.dataset)
        result["dft"] = {}
        for impl, tol in (("dft_highest", 1e-4), ("dft_high", 1e-3), ("dft_default", 2e-2)):
            errs = {}
            for name, got, want in zip(("linear", "mel"),
                                       wav_to_features(samples, cfg.dataset, impl), ref):
                d = (got - want).abs()
                errs[name] = {"max": float(d.max()), "mean": float(d.mean()),
                              "share_beyond": float((d > tol).float().mean())}
            log(f"  {impl} features vs default: {errs} (limit {tol} on 99% of the values)")
            if not max(e["share_beyond"] for e in errs.values()) <= 0.01:
                raise AssertionError(f"{impl}: {errs} beyond {tol}")
            result["dft"][impl] = errs

    # The prefetch: order and content of an epoch's first batches.
    n = 0
    for (b1, want), (b2, got) in zip(batcher.epoch(7, 32),
                                     tr._prefetch_to_device(batcher.epoch(7, 32), dev)):
        if b1 != b2 or any(not np.array_equal(want[k], torch.as_tensor(got[k]).cpu().numpy())
                           for k in want):
            raise AssertionError(f"prefetched batch {n} differs")
        n += 1
    log(f"  prefetch: {n} batches, equal and in order")

    # Timing on the same rows of bucket 1: 8 calls of each mode in turns
    # after a warm-up, each synchronized (a drifting host weighs on each
    # alike); host-fed uploads its rows through the prefetch every step.
    state = tr.create_state(cfg, seed=0, device=dev)
    batches = tr._prefetch_to_device(itertools.repeat((bucket, host)), dev)
    hstep = tr.make_train_step(cfg)
    cstep = tr.make_cached_train_step(cfg)
    gstep = tr.make_grouped_train_step(gcfg)
    runs = {"host-fed": (lambda: hstep(state, next(batches)[1]), 1),
            "cached": (lambda: cstep(state, rows, idx, valid), 1),
            "grouped S=4": (lambda: gstep(state, rows, idxs, valids), 4)}
    ms = {k: [] for k in runs}
    for rep in range(9):
        for k, (fn, per) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rep:  # the first round warms up
                ms[k].append((time.perf_counter() - t0) * 1e3 / per)
    result["ms_per_step"] = {k: statistics.median(v) for k, v in ms.items()}
    for k, v in ms.items():
        log(f"  {k}: median {statistics.median(v):.2f} ms a step ({[round(x, 2) for x in v]}) "
            f"[{card}]")
    result["profile"] = profile(lambda: cstep(state, rows, idx, valid), card)
    batches.close()
    del state

    # The driver: "auto" (the corpus fits), steps_per_call=4, host-fed.
    root = Path(__file__).resolve().parent / "chip_scratch" / "corpus"
    shutil.rmtree(root, ignore_errors=True)
    result["driver"] = {}
    totals = None
    for name, dcfg, steps_ in (("auto", cfg, 8), ("steps_per_call=4", gcfg, 8),
                               ("off", corpus_config(device_corpus_cache="off"), 4)):
        want = dict.fromkeys(counts(), 0)
        want.update(cli_expected(dcfg, [], "train", steps_))
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = tr.train(dcfg, root / name.replace("=", "_"), max_steps=steps_, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counts()
        log(f"  train {name}: {steps_} steps, wall {wall:.3f} s (corpus build, init, eval "
            f"included), launches {launches} [{card}]")
        if state.step != steps_ or launches != want:
            raise AssertionError(f"train {name}: step {state.step}, {launches} != {want}")
        result["driver"][name] = {"wall_s": wall, "launches": launches}
        totals = launches if totals is None else {k: totals[k] + v for k, v in launches.items()}
    result["launches"] = totals

    # What must raise: "on" over its budget, and a NaN under debug_nans.
    try:
        tr.train(corpus_config(device_corpus_cache="on", device_corpus_budget_mb=1),
                 root / "on", max_steps=1, device=dev)
    except ValueError as e:
        log(f"  device_corpus_cache=on over a 1 MiB budget raised: {e}")
    else:
        raise AssertionError("device_corpus_cache=on over budget did not raise")
    ncfg = corpus_config(debug_nans=True)
    state = tr.create_state(ncfg, seed=0, device=dev)
    with torch.no_grad():
        state.model.embedding.weight[5, 0] = float("nan")
    try:
        tr.make_cached_train_step(ncfg)(state, rows, idx, valid)
    except FloatingPointError as e:
        log(f"  debug_nans with a NaN planted in the embedding raised: {e}")
    else:
        raise AssertionError("debug_nans did not raise on a planted NaN")
    shutil.rmtree(root)
    return result


# --------------------------------------------------------------- phase 3f --


def with_arch(cfg, **fields):
    return cfg.replace(arch=dataclasses.replace(cfg.arch, **fields))


class Launches:
    """The launches of phase 3f's counted runs, summed by kernel."""

    def __init__(self):
        self.total = {}

    def run(self, what: str, fn, expected: dict):
        """`fn()` with the counters set to 0 just before and read just after;
        they must equal `expected` (kernels it does not name: 0)."""
        import torch

        reset()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        got = counts()
        want = dict.fromkeys(got, 0)
        want.update(expected)
        log(f"  {what}: launches {got}")
        if got != want:
            raise AssertionError(f"{what}: launches {got} != {want}")
        for k, n in got.items():
            self.total[k] = self.total.get(k, 0) + n
        return out


def synthesis_item(name, cfg, params, texts, ledger, expected, card):
    """A Synthesizer on `cfg`: one warm-up batch, then one timed batch with
    its launches held to `expected`; the waveforms finite and of the full
    length (stop threshold 1.1: every row runs max_decoder_steps)."""
    import numpy as np
    import torch

    from sstts_torch.synthesize import Synthesizer

    synth = Synthesizer(cfg, params, seed=0)
    synth.synthesize_batch(texts)
    torch.cuda.synchronize()

    def timed():
        t0 = time.perf_counter()
        wavs = synth.synthesize_batch(texts)
        return wavs, time.perf_counter() - t0

    wavs, wall = ledger.run(f"{name} synthesis batch", timed, expected)
    frames = cfg.inference.max_decoder_steps * cfg.arch.reduction_factor
    n_expected = (frames - 1) * cfg.dataset.hop_len
    for w in wavs:
        if w.shape != (n_expected,) or not np.isfinite(w).all():
            raise AssertionError(f"{name}: waveform {w.shape}, finite {np.isfinite(w).all()}")
    audio_s = len(wavs) * n_expected / cfg.dataset.sample_rate
    log(f"  {name} synthesis: b={len(texts)}, {frames} frames, "
        f"GL-{cfg.inference.griffin_lim_iters}, {cfg.inference.wire_format}: wall "
        f"{wall:.4f} s, {audio_s / wall:.2f} s audio / wall s [{card}]")
    return synth, wall


def train_item(name, cfg, batch, ledger, per_step: dict, timed_steps: int, card,
               teacher_impl=None):
    """A train state on `cfg`: one warm-up step, then `timed_steps` timed
    steps with their launches held to `per_step` each; every loss finite."""
    import numpy as np
    import torch

    from sstts_torch import train as tr

    state = tr.create_state(cfg, seed=0)
    state.model.teacher_impl = teacher_impl
    step = tr.make_train_step(cfg)
    step(state, batch)
    torch.cuda.synchronize()

    def timed():
        losses, ms = [], []
        for _ in range(timed_steps):
            t0 = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        return losses, ms

    want = {k: n * timed_steps for k, n in per_step.items()}
    losses, ms = ledger.run(f"{name}: {timed_steps} train steps", timed, want)
    log(f"  {name} train steps: losses {losses}; ms per step {ms} (median "
        f"{statistics.median(ms):.2f}) [{card}]")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss {losses}")
    return state, losses, ms


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


#: B4 and B6 against the plain loops of one bf16 model, relative L2 limits
#: by output: about three times the readings on the H100 (B4, 8 steps:
#: 5.2e-3, 3.8e-3, 1.6e-3; B6, 103 steps: 5.1e-3, 3.8e-3, 1.3e-3), which
#: are the size of the bf16 effect itself (4.3e-3 to 5.8e-3).
BF16_LOOP_TOL = {"mel": 1.5e-2, "stop_logits": 1.2e-2, "alignments": 5e-3}


def bf16_kernels_vs_loops(model, ids, mel_gt, dev) -> dict:
    """B4 and B6 on a bf16 model (bf16 matmuls, f32 state) against the same
    model's plain loops ("xla": the reference's scan, whose carry is bf16),
    at one dropout seed: the first 8 decode steps, and the 103
    teacher-forced steps of phase 3b."""
    import torch

    from sstts_torch.ops import decoder as dec
    from sstts_torch.synthesize import exact_f32

    a = model.arch
    r, steps = a.reduction_factor, 8
    with torch.no_grad(), exact_f32(dev):
        memory, mmask = model.encode(ids)
        loop = model.decode_infer(memory, mmask, steps, 1.1, steps, 10)
        kernel = dec.fused_decode(model.decoder_cell, memory, mmask, steps,
                                  stop_threshold=1.1, min_steps=steps, seed=10)
        teacher = {}
        for impl in ("xla", "fused"):
            model.teacher_impl = impl
            gen = torch.Generator(device=dev).manual_seed(11)
            mel, stops, align = model.decode_teacher(memory, mmask, mel_gt[:, : 103 * r], gen)
            teacher[impl] = {"mel": mel, "stop_logits": stops, "alignments": align}
        model.teacher_impl = None
    got = {"B4-S8": {k: rel_l2(kernel[k][:, : steps * r if k != "alignments" else steps],
                               loop[k][:, : steps * r if k != "alignments" else steps])
                     for k in BF16_LOOP_TOL},
           "B6-S103": {k: rel_l2(teacher["fused"][k], teacher["xla"][k]) for k in BF16_LOOP_TOL}}
    for name, errs in got.items():
        log(f"  bf16 model, {name} vs the plain loop: rel L2 {errs} (tol {BF16_LOOP_TOL})")
        if not all(errs[k] <= BF16_LOOP_TOL[k] for k in errs):
            raise AssertionError(f"bf16 {name} vs the plain loop: {errs}")
    return got


def variants_path(dev, card):
    """Phase 3f: the architectures the reference's model accepts beyond the
    default, at the default widths on the card."""
    import numpy as np
    import torch

    from sstts_torch import train as tr
    from sstts_torch.config import tiny_config
    from sstts_torch.model.tacotron import Tacotron, init_state_dict
    from sstts_torch.ops import decoder as dec
    from sstts_torch.synthesize import Synthesizer, exact_f32

    ledger = Launches()
    res = {}
    cfg = bench_config()
    texts = ["the quick brown fox jumps over the lazy dog " * 2] * 32
    params = init_state_dict(cfg.arch, cfg.dataset, seed=0)
    synth_expected = {"gru_sequence": 4, "fused_decode": 1, "fused_reproject_analyze": 60}
    train_cfg = corpus_config()
    tbatch = fixed_batch(train_cfg, 32, 1, (10, 16))
    train_per_step = {"gru_sequence": 4, "gru_sequence_backward": 4, "fused_teacher_scan": 1}

    # -- bf16: synthesis (B3 4, B4 1, B2 60), then the same weights' f32
    # and bf16 models on one text batch, its f32 synthesis as the teacher.
    bf16_cfg = with_arch(cfg, compute_dtype="bfloat16")
    synth16, res["bf16_synthesis_wall_s"] = synthesis_item(
        "bf16", bf16_cfg, params, texts, ledger, synth_expected, card)
    synth32 = Synthesizer(cfg, params, seed=0)
    _, full = synth32.synthesize_batch(texts, full_output=True,
                                       fetch=("wav", "n_samples", "mel", "n_frames"))
    ids = torch.as_tensor(synth32._encode_ids(texts, None), dtype=torch.long).to(dev)
    mel_gt = torch.as_tensor(full["mel"]).to(dev)
    fmask = torch.arange(mel_gt.shape[1], device=dev)[None] < torch.as_tensor(
        full["n_frames"]).to(dev)[:, None]
    outs, decs = {}, {}
    with torch.no_grad(), exact_f32(dev):
        for name, sy in (("f32", synth32), ("bf16", synth16)):
            gen = torch.Generator(device=dev).manual_seed(5)
            outs[name] = sy.model(ids, mel_gt, fmask, gen)
            memory, mmask = sy.model.encode(ids)
            decs[name] = dec.fused_decode(sy.model.decoder_cell, memory, mmask, 8,
                                          stop_threshold=1.1, min_steps=8, seed=6)
    # Limits: bf16 rounds every activation to 8 bits of mantissa (relative
    # steps of 2^-8 = 3.9e-3), which the recurrences carry; on the tiny
    # config the effect reads 2e-3 to 5e-3 (tests/test_torch_bf16.py).
    forward = {k: rel_l2(outs["bf16"][k], outs["f32"][k]) for k in ("mel", "linear")}
    decode8 = rel_l2(decs["bf16"]["mel"], decs["f32"]["mel"])
    log(f"  bf16 vs f32, same weights: teacher-forced forward rel L2 {forward} "
        f"(tol 2e-2), 8 decode steps (B4) mel rel L2 {decode8:.3e} (tol 2e-2)")
    if not (max(forward.values()) < 2e-2 and decode8 < 2e-2):
        raise AssertionError(f"bf16 vs f32: forward {forward}, decode {decode8}")
    res.update(bf16_forward_rel_l2=forward, bf16_decode8_rel_l2=decode8)
    res["bf16_kernels_vs_loops_rel_l2"] = bf16_kernels_vs_loops(synth16.model, ids, mel_gt, dev)

    # -- bf16: train steps (4/4/1 a step), the loss falling; the first
    # step's gradient against the f32 step's from the same init and batch.
    bf16_train = with_arch(train_cfg, compute_dtype="bfloat16")
    state16, losses, ms = train_item("bf16", bf16_train, tbatch, ledger, train_per_step, 5, card)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"bf16: the loss did not fall over 5 steps: {losses}")
    res.update(bf16_train_losses=losses, bf16_train_ms=ms)
    grads = {}
    for name, c in (("f32", train_cfg), ("bf16", bf16_train)):
        st = tr.create_state(c, seed=0)
        tr.make_train_step(c)(st, tbatch)
        # The step clips by the global norm: one scale for every leaf,
        # which the cosine ignores.
        grads[name] = torch.cat([p.grad.flatten() for p in st.model.parameters()])
    cos = float(torch.nn.functional.cosine_similarity(grads["bf16"], grads["f32"], 0))
    log(f"  bf16 vs f32 first-step gradient: cosine {cos:.6f} (tol >= 0.999)")
    if not cos >= 0.999:
        raise AssertionError(f"bf16 gradient cosine {cos}")
    res["bf16_grad_cosine"] = cos
    res["bf16_tiny_card_vs_cpu_rel"] = tiny_step_card_vs_cpu(
        with_arch(tiny_config(), compute_dtype="bfloat16"), 2e-2)

    # -- local-Luong attention: the plain decoder loop and teacher scan on
    # the card (B4 and B6 implement Bahdanau only, as in the reference).
    luong_cfg = with_arch(cfg, attention_type="local_luong")
    lparams = init_state_dict(luong_cfg.arch, luong_cfg.dataset, seed=0)
    lsynth, res["luong_synthesis_wall_s"] = synthesis_item(
        "luong", luong_cfg, lparams, texts, ledger,
        {"gru_sequence": 4, "fused_reproject_analyze": 60}, card)
    _, lfull = lsynth.synthesize_batch(texts[:4], full_output=True,
                                       fetch=("wav", "n_samples", "alignments"))
    row_sums = lfull["alignments"].sum(-1)
    log(f"  luong alignments: rows sum to 1 within {np.abs(row_sums - 1).max():.2e} "
        "(tol 1e-3)")
    if not np.abs(row_sums - 1).max() < 1e-3:
        raise AssertionError("luong alignment rows do not sum to 1")
    _, losses, ms = train_item(
        "luong", with_arch(train_cfg, attention_type="local_luong"), tbatch, ledger,
        {"gru_sequence": 4, "gru_sequence_backward": 4}, 2, card)
    res.update(luong_train_losses=losses, luong_train_ms=ms)
    ltiny = with_arch(tiny_cfg(), attention_type="local_luong", local_attention_window=2)
    res["luong_tiny_card_vs_cpu_rel_l2"] = tiny_card_vs_cpu(
        with_inference(ltiny, decoder_impl=None))
    res["luong_tiny_step_card_vs_cpu_rel"] = tiny_step_card_vs_cpu(
        with_arch(tiny_config(), attention_type="local_luong", local_attention_window=2),
        1e-4)

    # -- the fused conv bank: the encoder's bank fused and unfused on the
    # same parameters (f32, TF32 off: another conv algorithm, 1e-4), then
    # train steps.
    fcfg = with_arch(train_cfg, fused_conv_bank=True)
    model = Tacotron(fcfg.arch, fcfg.dataset)
    model.load_state_dict(init_state_dict(fcfg.arch, fcfg.dataset, seed=0))
    bank = model.encoder_cbhg.bank.to(dev).eval()
    g = torch.Generator().manual_seed(7)
    x = torch.randn(32, 128, bank.conv1.shape[1], generator=g).to(dev)
    xmask = torch.arange(128, device=dev)[None] < torch.randint(40, 129, (32, 1), generator=g).to(dev)
    with torch.no_grad(), exact_f32(dev):
        fused = bank(x, xmask)
        bank.fused = False
        unfused = bank(x, xmask)
    bank_err = max_err(fused, unfused)
    log(f"  fused conv bank vs unfused (K={bank.bank_k}, {tuple(x.shape)}): max_abs_err "
        f"{bank_err:.3e} (tol 1e-4)")
    if not bank_err < 1e-4:
        raise AssertionError(f"fused bank: {bank_err}")
    _, losses, ms = train_item("fused bank", fcfg, tbatch, ledger, train_per_step, 2, card)
    res.update(fused_bank_max_abs_err=bank_err, fused_bank_train_ms=ms)

    # -- the reference's "xla" names on the card at the default
    # architecture: the plain loops, held to B4 and B6 on the same inputs
    # and dropout seed.
    xsynth, res["xla_decoder_synthesis_wall_s"] = synthesis_item(
        "decoder_impl=xla", with_inference(cfg, decoder_impl="xla"), params, texts, ledger,
        {"gru_sequence": 4, "fused_reproject_analyze": 60}, card)
    model = xsynth.model
    with torch.no_grad(), exact_f32(dev):
        memory, mmask = model.encode(ids)
        plain = model.decode_infer(memory, mmask, 20, 1.1, 8, 8)
        kernel = {dt: dec.fused_decode(model.decoder_cell, memory, mmask, 20,
                                       stop_threshold=1.1, min_steps=8, seed=8,
                                       matmul_dtype=dt)
                  for dt in (torch.float32, torch.bfloat16)}
        teacher_mel = mel_gt[:, : 103 * cfg.arch.reduction_factor]  # phase 3b's 103 steps
        teacher = {}
        for impl, dt in (("xla", None), ("fused", torch.float32), ("fused", torch.bfloat16)):
            model.teacher_impl, model.teacher_dtype = impl, dt
            gen = torch.Generator(device=dev).manual_seed(9)
            teacher[(impl, dt)] = model.decode_teacher(memory, mmask, teacher_mel, gen)
        model.teacher_impl = model.teacher_dtype = None
    # f32 products: the same arithmetic in another order, all 20 steps;
    # bf16 products against the f32 loop: the first 8 steps (their
    # roundings feed back through the decoded frames).
    errs = {}
    r = cfg.arch.reduction_factor
    for dt, got in kernel.items():
        steps = 20 if dt == torch.float32 else 8
        mel_p, al_p = plain["mel"][:, : steps * r], plain["alignments"][:, :steps]
        tol = ring_tolerances(dt, True, float(mel_p.abs().max()), float(al_p.max()))
        errs[f"B4-{str(dt)[6:]}-S{steps}"] = (max_err(got["mel"][:, : steps * r], mel_p),
                                              max_err(got["alignments"][:, :steps], al_p), tol)
    ref = teacher[("xla", None)]
    for key in (("fused", torch.float32), ("fused", torch.bfloat16)):
        got = teacher[key]
        tol = ring_tolerances(key[1], True, float(ref[0].abs().max()), float(ref[2].max()))
        errs[f"B6-{str(key[1])[6:]}"] = (max_err(got[0], ref[0]), max_err(got[2], ref[2]), tol)
    for k, (e_mel, e_al, (t_mel, t_al)) in errs.items():
        log(f"  xla plain loop vs {k}: mel max_abs_err {e_mel:.3e} (tol {t_mel:.1e}), "
            f"alignments {e_al:.3e} (tol {t_al:.1e})")
        if not (e_mel <= t_mel and e_al <= t_al):
            raise AssertionError(f"xla vs {k}: {e_mel}, {e_al}")
    res["xla_vs_kernels"] = {k: v[:2] for k, v in errs.items()}
    _, losses, ms = train_item("teacher_impl=xla", train_cfg, tbatch, ledger,
                               {"gru_sequence": 4, "gru_sequence_backward": 4}, 2, card,
                               teacher_impl="xla")
    res.update(xla_teacher_train_ms=ms)
    res["launches"] = ledger.total
    return res


# --------------------------------------------------------------- phase 3g --


def mesh_synthesis(cfg, params, texts, devices, card) -> dict:
    """`Synthesizer(mesh=G devices)` in both partitions against one device
    on the same card: "gspmd" draws one device's dropout bits and must give
    its audio (bit-equal at G = 1, the same shapes; 2e-2 relative L2 at
    G > 1, where the shards' products run at other batch sizes through the
    bf16 loop); "shard_map" draws a stream a shard and must keep the stop
    trim.  A warm-up batch, then one timed batch with the counters set to 0
    just before and read just after, and each shard's launches."""
    import numpy as np
    import torch

    from sstts_torch.parallel.mesh import make_mesh
    from sstts_torch.synthesize import Synthesizer

    G = len(devices)
    mesh = make_mesh(devices)

    def sync():
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    single = Synthesizer(cfg, params, seed=0, device=devices[0])
    single.synthesize_batch(texts)
    sync()
    t0 = time.perf_counter()
    want = single.synthesize_batch(texts)
    one_wall = time.perf_counter() - t0
    res = {"one_device_wall_s": one_wall, "launches": {}}
    total = dict.fromkeys(counts(), 0)
    for partition in ("gspmd", "shard_map"):
        synth = Synthesizer(cfg, params, seed=0, mesh=mesh, partition=partition)
        synth.synthesize_batch(texts)
        sync()
        per_shard = []
        run = synth._run_shard

        def counted(i, ids, max_steps, dropout, run=run, per_shard=per_shard):
            before = counts()
            out = run(i, ids, max_steps, dropout)
            per_shard.append({k: n - before[k] for k, n in counts().items() if n - before[k]})
            return out

        synth._run_shard = counted
        reset()
        sync()
        t0 = time.perf_counter()
        got = synth.synthesize_batch(texts)
        wall = time.perf_counter() - t0
        launches = counts()
        for k, n in launches.items():
            total[k] += n
        want_shard = {"gru_sequence": 4, "fused_decode": 1,
                      "fused_reproject_analyze": cfg.inference.griffin_lim_iters}
        log(f"  {partition} on {G} device(s): wall {wall:.4f} s (one device {one_wall:.4f} s, "
            f"x{one_wall / wall:.3f}); launches by device {per_shard} [{card}]")
        if per_shard != [want_shard] * G:
            raise AssertionError(f"{partition}: launches by device {per_shard}")
        lengths = [len(w) for w in got]
        if partition == "gspmd":
            err = rel_l2(torch.as_tensor(np.concatenate(got)),
                         torch.as_tensor(np.concatenate(want)))
            tol = 0.0 if G == 1 else 2e-2
            log(f"  gspmd vs one device: wav rel L2 {err:.3e} (tol {tol}), lengths equal "
                f"{lengths == [len(w) for w in want]}")
            if lengths != [len(w) for w in want] or not err <= tol:
                raise AssertionError(f"gspmd vs one device: {err}")
        else:
            hop = cfg.dataset.hop_len
            bad = [n for n in lengths if n <= 0 or n % hop]
            if bad or not all(np.isfinite(w).all() for w in got):
                raise AssertionError(f"shard_map trim: {lengths}")
            err = rel_l2(torch.as_tensor(np.concatenate(got)),
                         torch.as_tensor(np.concatenate(want)))
            log(f"  shard_map: its own streams, wav rel L2 {err:.3e} from one device's "
                f"(dropout at inference on: a stream a shard)")
        res[partition] = {"wall_s": wall, "rel_l2_vs_one_device": err,
                          "launches_by_device": per_shard}
    res["launches"] = total
    return res


def mesh_training(cfg, batch, G, card, kind="cuda") -> dict:
    """4 steps on phase 3b's batch at the default widths, one device in
    this process against (G, 1) over NCCL (`mesh.launch`, a process a
    card), and (2, 1) and (1, 2) where there are two cards, all under
    PyTorch's deterministic algorithms, from one init at lr 2e-4.  Limits:
    the loss and the gradient norm within rtol 1e-5 at steps 1 and 2 and
    1e-3 at 3 and 4 (Adam carries last-bit differences of near-zero
    gradients into every later step); the parameters within 1e-4 relative
    L2 over the elements whose first moment exceeds 1e-5 (|g| > ~1e-4) and
    1e-3 over all.  Every rank's launches: B3 4, B3' 4, B6 1 a step."""
    import torch

    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.parallel.mesh import launch
    from sstts_torch.tools.mesh_steps import run_steps

    cfg = cfg.replace(training=dataclasses.replace(cfg.training, learning_rate=2e-4))
    params = init_state_dict(cfg.arch, cfg.dataset, 0)
    batches = [batch] * 4
    one = run_steps(cfg, params, batches, kind, None, True)
    layouts = [(G, 1)] + [lay for lay in ((2, 1), (1, 2)) if G >= 2 and lay != (G, 1)]
    res = {"one_device_ms": [w * 1e3 for w in one["walls"]], "layouts": {}}
    per_step = {"gru_sequence": 4, "gru_sequence_backward": 4, "fused_teacher_scan": 1}
    launches = dict.fromkeys(counts(), 0)
    for data, model in layouts:
        t0 = time.perf_counter()
        ranks = launch(run_steps, data * model, cfg, params, batches, kind, (data, model),
                       True, device=kind, timeout=900.0)
        wall = time.perf_counter() - t0
        r = ranks[0]
        name = f"{data}x{model}"
        want = dict.fromkeys(counts(), 0)
        want.update({k: 4 * n for k, n in per_step.items()})
        for rank in ranks:
            if rank["launches"] != want:
                raise AssertionError(f"{name} rank {rank['rank']}: launches {rank['launches']}")
            for k, n in rank["launches"].items():
                launches[k] += n
        m_err = {k: [abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(r["metrics"], one["metrics"])]
                 for k in ("loss", "grad_norm")}
        sel = {n: v["exp_avg"].abs() > 1e-5 for n, v in one["moments"].items()}
        num = sum(float((r["params"][n] - p)[sel[n]].double().pow(2).sum())
                  for n, p in one["params"].items())
        den = sum(float(p[sel[n]].double().pow(2).sum()) for n, p in one["params"].items())
        p_sel = (num / den) ** 0.5
        p_all = rel_l2(torch.cat([v.reshape(-1) for v in r["params"].values()]),
                       torch.cat([v.reshape(-1) for v in one["params"].values()]))
        differing = sum(int((r["params"][n] != p).any()) for n, p in one["params"].items())
        ms = [w * 1e3 for w in r["walls"]]
        log(f"  {name} over NCCL ({data * model} rank(s)): loss rel errors {m_err['loss']}, "
            f"grad_norm {m_err['grad_norm']}; parameters rel L2 {p_sel:.3e} where |m| > 1e-5, "
            f"{p_all:.3e} over all, {differing} of {len(one['params'])} tensors differ at "
            f"all; ms a step {ms} (one device {res['one_device_ms']}); launch wall "
            f"{wall:.2f} s [{card}]")
        ok = all(max(e[:2]) <= 1e-5 and max(e) <= 1e-3 for e in m_err.values())
        if not (ok and p_sel <= 1e-4 and p_all <= 1e-3):
            raise AssertionError(f"{name} vs one device: {m_err}, {p_sel}, {p_all}")
        res["layouts"][name] = {"metric_rel_err": m_err, "params_rel_l2": p_sel,
                                "params_rel_l2_all": p_all, "tensors_differing": differing,
                                "ms_per_step": ms, "launch_wall_s": wall}
    res["launches"] = launches
    return res


def check_matmul_fft(dev, card) -> dict:
    """`dsp/fft.rfft`/`irfft` (the matmul FFT) against `torch.fft` at
    (25600, 2048) f32, with the caller's TF32 switch on to show the
    transform turns it off (a TF32 pass would miss by ~1e-3): 1e-5
    relative L2; their times beside torch.fft's."""
    import torch

    from sstts_torch.dsp import fft as mmfft

    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(25600, 2048, device=dev, generator=g)
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        spec = mmfft.rfft(x, 2048)
        back = mmfft.irfft(spec, 2048)
        ct_ms = cuda_ms(lambda: mmfft.rfft(x, 2048), iters=5, reps=3)
        ict_ms = cuda_ms(lambda: mmfft.irfft(spec, 2048), iters=5, reps=3)
    finally:
        matmul.allow_tf32 = saved
    ref = torch.fft.rfft(x.double())
    err = float((spec.to(torch.complex128) - ref).abs().norm() / ref.abs().norm())
    err_i = float((back - x).norm() / x.norm())
    fft_ms = cuda_ms(lambda: torch.fft.rfft(x), iters=5, reps=3)
    ifft_ms = cuda_ms(lambda: torch.fft.irfft(spec, n=2048), iters=5, reps=3)
    log(f"  matmul FFT (25600, 2048) f32: rfft rel L2 {err:.3e}, irfft round trip "
        f"{err_i:.3e} (tol 1e-5, TF32 switched on by the caller); rfft {ct_ms:.4f} ms "
        f"(torch.fft {fft_ms:.4f} ms), irfft {ict_ms:.4f} ms (torch.fft {ifft_ms:.4f} ms) "
        f"[{card}]")
    if not (err <= 1e-5 and err_i <= 1e-5):
        raise AssertionError(f"matmul FFT: {err}, {err_i}")
    return {"rfft_rel_l2": err, "irfft_rel_l2": err_i, "rfft_ms": ct_ms,
            "torch_rfft_ms": fft_ms, "irfft_ms": ict_ms, "torch_irfft_ms": ifft_ms}


def check_ct_matmul_gl(cfg, params, texts, card) -> dict:
    """One GL-60 batch of bench.py's workload with `fft_impl="ct_matmul"`
    against `"xla"` (torch.fft), the same seed, so the same spectrogram:
    both are the complex f32 loop, whose last-place differences become
    phase changes at near-silent bins (check_f32_loop's reason, 5e-3 over
    8 iterations); over 60, 1e-2 relative L2."""
    import numpy as np
    import torch

    from sstts_torch.synthesize import Synthesizer

    out, walls = {}, {}
    for impl in ("xla", "ct_matmul"):
        synth = Synthesizer(with_inference(cfg, griffin_lim_fft_impl=impl), params, seed=0)
        t0 = time.perf_counter()
        wavs, _ = synth.synthesize_batch(texts, full_output=True, fetch=["wav", "n_samples"])
        walls[impl] = time.perf_counter() - t0
        out[impl] = np.concatenate(wavs)  # f32, before the PCM16 wire rounds it
    err = rel_l2(torch.as_tensor(out["ct_matmul"]), torch.as_tensor(out["xla"]))
    log(f"  GL-60 b=32 fft_impl=ct_matmul vs xla: wav rel L2 {err:.3e} (tol 1e-2); walls "
        f"{walls} (each its first batch) [{card}]")
    if not err <= 1e-2:
        raise AssertionError(f"ct_matmul Griffin-Lim: {err}")
    return {"rel_l2": err, "walls_s": walls}


def check_native_decoder(card) -> dict:
    """The native WAV decoder, trimmer and ADPCM rows on this host against
    the numpy codec: the library must build (g++ is here); decode and trim
    bit-equal, ADPCM within 1e-6."""
    import shutil

    import numpy as np
    import torch

    from sstts_torch.data import native_loader, pipeline
    from sstts_torch.data import wav as wav_mod
    from sstts_torch.dsp import ops

    if not native_loader.available():
        raise AssertionError("the native decoder did not build (g++)")
    root = Path(__file__).resolve().parent / "chip_scratch" / "native_wavs"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    rng = np.random.default_rng(4)
    paths = []
    for i in range(8):
        n = int(rng.integers(20000, 90000))
        y = (0.4 * np.sin(np.linspace(0, 300 + 40 * i, n))).astype(np.float32)
        y[: n // 8] = 0.0
        paths.append(root / f"u{i}.wav")
        wav_mod.save_wav(paths[-1], y, 22050)
    t0 = time.perf_counter()
    native = [native_loader.load_wav(p) for p in paths]
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_ = [wav_mod.load_wav(p) for p in paths]
    t_numpy = time.perf_counter() - t0
    for (a, sa), (b, sb) in zip(native, numpy_):
        trimmed = native_loader.trim_silence(a, 60.0)
        if sa != sb or not np.array_equal(a, b) or not np.array_equal(
                trimmed, pipeline.trim_silence(b, 60.0)):
            raise AssertionError("native decode/trim differs from numpy")
    wav = np.clip(rng.standard_normal((4, 22050)).astype(np.float32) * 0.3, -1, 1)
    adpcm = {}
    for bits in (4, 3, 2):
        rows = getattr(ops, f"adpcm{bits}_encode_wire")(torch.as_tensor(wav)).numpy()
        got = native_loader.adpcm_decode_rows(rows, bits)
        want = getattr(ops, f"_adpcm{bits}_decode_rows_np")(rows)
        adpcm[bits] = float(np.abs(got - want).max())
    shutil.rmtree(root)
    log(f"  native decoder: 8 WAVs decoded and trimmed bit-equal to numpy "
        f"({t_native * 1e3:.2f} ms native, {t_numpy * 1e3:.2f} ms numpy, host time); ADPCM "
        f"rows max abs err {adpcm} (tol 1e-6) [{card}]")
    if max(adpcm.values()) > 1e-6:
        raise AssertionError(f"native ADPCM rows: {adpcm}")
    return {"decode_ms": t_native * 1e3, "numpy_decode_ms": t_numpy * 1e3, "adpcm_max_err": adpcm}


def mesh_path(dev, card):
    """Phase 3g: the mesh (synthesis in both partitions, training over
    NCCL), the matmul FFT and the native decoder."""
    import torch

    from sstts_torch.config import Config
    from sstts_torch.model.tacotron import init_state_dict

    G = torch.cuda.device_count()
    if G == 1:
        log("  one card: the mesh runs at G = 1 (one data shard, one NCCL rank); the "
            "(2, 1) and (1, 2) layouts, tensor parallelism among them, were not run on "
            "the card (they need two)")
    cfg = bench_config()
    texts = ["the quick brown fox jumps over the lazy dog " * 2] * 32
    params = init_state_dict(cfg.arch, cfg.dataset, seed=0)
    devices = [torch.device("cuda", i) for i in range(G)]
    res = {"devices": G, "synthesis": mesh_synthesis(cfg, params, texts, devices, card)}
    tcfg = Config()
    tcfg = tcfg.replace(
        dataset=dataclasses.replace(tcfg.dataset, dataset="synthetic"),
        training=dataclasses.replace(tcfg.training, batch_size=32),
    )
    res["training"] = mesh_training(tcfg, fixed_batch(tcfg, 32, 1, (10, 16)), G, card)
    res["launches"] = {k: res["synthesis"]["launches"][k] + res["training"]["launches"][k]
                       for k in res["synthesis"]["launches"]}
    res["matmul_fft"] = check_matmul_fft(dev, card)
    res["ct_matmul_gl"] = check_ct_matmul_gl(cfg, params, texts, card)
    res["native"] = check_native_decoder(card)
    return res


# --------------------------------------------------------------- phase 3i --


def widths_path(dev, card, arch=None, kind: str = "wide", phase: str = "3i"):
    """Phase 3i: the default Config() with its recurrent widths doubled
    (WIDE_ARCH) on the card, from a seeded init: bench.py's batch through
    `Synthesizer` (B3 4 on the wide kind, B4 1 in column panels, B2 60), its
    decode held to the plain loop (`decode_infer`, what decoder_impl="xla"
    runs) on the same weights and dropout seed with phase 3f's limits, and 3
    train steps on phase 3b's bucket (B3 4, B3' 4, B6 1 a step) with the
    loss finite and falling; the first step's gradient against the teacher
    "xla" step's from the same init (cosine at least 0.999).  Phase 3j runs
    the same on GRID_ARCH, whose BiGRUs take the grid kind, and phase 3k on
    STREAM_ARCH, whose BiGRUs take the grid kind with the streamed slice
    (`wide_kind` "streamed")."""
    import torch

    from sstts_torch import train as tr
    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.ops import decoder as dec
    from sstts_torch.synthesize import exact_f32

    arch = WIDE_ARCH if arch is None else arch
    name = {"3i": "widths", "3j": "grid", "3k": "stream"}[phase]
    ledger = Launches()
    res = {}
    cfg = with_arch(bench_config(), **arch)
    kinds = {H: gru_kind(H) for H in (cfg.arch.encoder_gru_units, cfg.arch.post_gru_units)}
    log(f"  widths {arch}: the BiGRUs' kernels {kinds}")
    if not all(wide_kind(H) == kind for H in kinds):
        raise AssertionError(f"phase {phase}'s BiGRUs do not take the {kind} kernels: {kinds}")
    texts = ["the quick brown fox jumps over the lazy dog " * 2] * 32
    params = init_state_dict(cfg.arch, cfg.dataset, seed=0)
    synth, res["synthesis_wall_s"] = synthesis_item(
        name, cfg, params, texts, ledger,
        {"gru_sequence": 4, "fused_decode": 1, "fused_reproject_analyze": 60}, card)

    # The decode against the plain loop: f32 products over 20 steps, bf16
    # products over the first 8 (their roundings feed back through the
    # decoded frames), as phase 3f holds the default widths.
    model = synth.model
    ids = torch.as_tensor(synth._encode_ids(texts, None), dtype=torch.long).to(dev)
    with torch.no_grad(), exact_f32(dev):
        memory, mmask = model.encode(ids)
        plain = model.decode_infer(memory, mmask, 20, 1.1, 8, 8)
        kernel = {dt: dec.fused_decode(model.decoder_cell, memory, mmask, 20,
                                       stop_threshold=1.1, min_steps=8, seed=8,
                                       matmul_dtype=dt)
                  for dt in (torch.float32, torch.bfloat16)}
    r = cfg.arch.reduction_factor
    res["xla_vs_B4"] = {}
    for dt, got in kernel.items():
        steps = 20 if dt == torch.float32 else 8
        mel_p, al_p = plain["mel"][:, : steps * r], plain["alignments"][:, :steps]
        tol_mel, tol_al = ring_tolerances(dt, True, float(mel_p.abs().max()), float(al_p.max()))
        e_mel = max_err(got["mel"][:, : steps * r], mel_p)
        e_al = max_err(got["alignments"][:, :steps], al_p)
        log(f"  {name}: xla plain loop vs B4-{str(dt)[6:]}-S{steps}: mel max_abs_err "
            f"{e_mel:.3e} (tol {tol_mel:.1e}), alignments {e_al:.3e} (tol {tol_al:.1e})")
        if not (e_mel <= tol_mel and e_al <= tol_al):
            raise AssertionError(f"{name}: xla vs B4 {dt}: {e_mel}, {e_al}")
        res["xla_vs_B4"][f"{str(dt)[6:]}-S{steps}"] = (e_mel, e_al)

    train_cfg = with_arch(corpus_config(), **arch)
    tbatch = fixed_batch(train_cfg, 32, 1, (10, 16))
    _, losses, ms = train_item(
        name, train_cfg, tbatch, ledger,
        {"gru_sequence": 4, "gru_sequence_backward": 4, "fused_teacher_scan": 1}, 3, card)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: the loss did not fall over 3 steps: {losses}")
    res.update(train_losses=losses, train_ms=ms)
    grads = {}
    for impl in (None, "xla"):
        st = tr.create_state(train_cfg, seed=0)
        st.model.teacher_impl = impl
        tr.make_train_step(train_cfg)(st, tbatch)
        grads[impl] = torch.cat([p.grad.flatten() for p in st.model.parameters()]).double()
    cos = float(torch.nn.functional.cosine_similarity(grads[None], grads["xla"], 0))
    log(f"  {name}: first-step gradient, B6 against the teacher xla loop: cosine {cos:.6f} "
        f"(tol >= 0.999)")
    if not cos >= 0.999:
        raise AssertionError(f"{name}: gradient cosine {cos}")
    res["grad_cosine_vs_xla"] = cos
    res["launches"] = ledger.total
    return res


def tiny_step_card_vs_cpu(tcfg, tol: float) -> dict:
    """One tiny train step on the card (kernels where the architecture has
    them, B6 with f32 products) against the same step on the CPU (plain
    versions), dropout off: loss and gradient norm within `tol` relative."""
    import torch

    from sstts_torch import train as tr

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
        if tcfg.arch.attention_type == "bahdanau":
            st.model.teacher_impl, st.model.teacher_dtype = "fused", torch.float32
        res[name] = {k: float(v) for k, v in tstep(st, tbatch).items()}
    rel_diff = {k: rel(res["card"][k], res["cpu"][k]) for k in ("loss", "grad_norm")}
    log(f"  tiny train step ({tcfg.arch.compute_dtype}, {tcfg.arch.attention_type}), card "
        f"vs CPU: relative differences {rel_diff} (tol {tol})")
    if not max(rel_diff.values()) <= tol:
        raise AssertionError(f"tiny train step card vs CPU: {rel_diff}")
    return rel_diff


# --------------------------------------------------------------- phase 3l --


def gate_path(dev, card):
    """Phase 3l: the per-shape gates (module docstring) at the default
    Config() widths, B = 1, 4 decoder steps and Griffin-Lim 4."""
    import numpy as np
    import torch

    from sstts_torch import train as tr
    from sstts_torch.config import Config
    from sstts_torch.data import pipeline
    from sstts_torch.data.synthetic import make_utterances
    from sstts_torch.model.tacotron import init_state_dict
    from sstts_torch.ops import decoder as dec
    from sstts_torch.ops import teacher as tops
    from sstts_torch.synthesize import Synthesizer

    cfg = Config()
    reach = dec.text_reach(dec.cell_widths(_default_cell(cfg)), dev)
    reach6 = tops.text_reach(tops.cell_widths(_default_cell(cfg)), dev)
    log(f"  B4 reach T = {reach}, B6 reach T = {reach6} (the libraries' counts)")
    if reach < 4096 or reach6 < 4096:
        raise AssertionError(f"reaches {reach}, {reach6}")
    cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset, dataset="synthetic",
                                                  max_text_len=reach6 + 64))
    cfg = with_inference(cfg, max_decoder_steps=4, griffin_lim_iters=4, stop_threshold=1.1)
    params = init_state_dict(cfg.arch, cfg.dataset, seed=0)
    text = ["the quick brown fox jumps over the lazy dog " * 8]
    ledger = Launches()
    res = {"reach": reach, "reach_teacher": reach6}
    outs, routes = {}, {}
    for impl in ("auto", "fused", "xla"):
        synth = Synthesizer(with_inference(cfg, decoder_impl=impl), params, seed=0)
        want = {"gru_sequence": 4, "fused_reproject_analyze": 4}
        _, outs[impl] = ledger.run(
            f"decoder_impl={impl} at T={reach + 1}",
            lambda: synth.synthesize_batch(text, text_bucket=reach + 1, full_output=True,
                                           fetch=("wav", "n_samples", "mel")), want)
        routes[impl] = dict(synth.decode_routes)
        if impl == "auto":
            ledger.run(f"decoder_impl=auto at T={reach}",
                       lambda: synth.synthesize_batch(text, text_bucket=reach),
                       dict(want, fused_decode=1))
            routes["auto"] = dict(synth.decode_routes)
    log(f"  decode routes: {routes}")
    if routes != {"auto": {reach + 1: "xla", reach: "fused"}, "fused": {reach + 1: "xla"},
                  "xla": {reach + 1: "xla"}}:
        raise AssertionError(f"decode routes {routes}")
    for impl in ("auto", "fused"):
        for k in ("wav", "mel", "n_samples"):
            if not np.array_equal(outs[impl][k], outs["xla"][k]):
                raise AssertionError(f"{impl} past the reach: {k} differs from xla's")
    if not np.isfinite(outs["xla"]["wav"]).all():
        raise AssertionError("gated synthesis: non-finite audio")
    res["decode_routes"] = {k: {str(t): r for t, r in v.items()} for k, v in routes.items()}

    # One train step at one past B6's reach: teacher "auto" takes the plain
    # scan, an explicit "fused" is refused before any launch.
    hop, r = cfg.dataset.hop_len, cfg.arch.reduction_factor
    batcher = pipeline.Batcher(make_utterances(4, cfg.dataset, 10, 16), cfg)
    u, ids = batcher.examples[0]
    audio = batcher.audio(u)
    frames = -(-(1 + len(audio) // hop) // r) * r
    batch = pipeline.make_batch([(ids, audio)], reach6 + 1, frames, cfg)
    state = tr.create_state(cfg, seed=0)
    step = tr.make_train_step(cfg)
    m = ledger.run(f"train step at T={reach6 + 1}, teacher auto", lambda: step(state, batch),
                   {"gru_sequence": 4, "gru_sequence_backward": 4})
    loss = float(m["loss"])
    state.model.teacher_impl = "fused"
    reset()
    try:
        step(state, batch)
        raise AssertionError(f"teacher 'fused' took T={reach6 + 1}")
    except NotImplementedError as e:
        log(f"  teacher 'fused' at T={reach6 + 1} refused: {e}")
    if counts()["fused_teacher_scan"] or not np.isfinite(loss):
        raise AssertionError(f"gated train step: loss {loss}, {counts()}")
    log(f"  train step at T={reach6 + 1} (teacher auto, plain scan): loss {loss:.5f} [{card}]")
    res.update(train_loss=loss, launches=ledger.total)
    return res


def _default_cell(cfg):
    """A decoder cell of `cfg`'s widths (its widths alone are read)."""
    from sstts_torch.model.decoder import DecoderCell

    return DecoderCell(cfg.arch, cfg.dataset.n_mels, 2 * cfg.arch.encoder_gru_units)


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
            check_decoder(dev), check_gl(dev), check_reproject(dev), check_gl_fused(dev),
        ]
        # The wide configurations (B3 and B3' past H = 137, B4 and B6 in
        # column panels), each a row of its own, driven by phase 3i; B3 and
        # B3' from H = 544 to 1419 (the grid kind), driven by phase 3j; past
        # 1419 (the grid kind streaming part of each slice), driven by
        # phase 3k.
        wide = [check_gru_wide(dev, "wide"), check_gru_backward_wide(dev, "wide"),
                check_teacher_wide(dev), check_decoder_wide(dev)]
        grid = [check_gru_wide(dev, "grid"), check_gru_backward_wide(dev, "grid")]
        stream = [check_gru_wide(dev, "streamed"), check_gru_backward_wide(dev, "streamed")]
    for k in kernels + wide + grid + stream:
        log(f"  {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}) [{card}]")

    log("phase 3: the synthesis path")
    main_res = main_path(dev, card)
    log("phase 3c: the serving path")
    serve_res = serving_path(dev, card)
    log("phase 3b: the training path")
    train_res = train_path(dev, card)
    log("phase 3d: the command line")
    cli_res = cli_path(dev, card)
    log("phase 3e: the resident corpus")
    corpus_res = corpus_path(dev, card)
    log("phase 3f: the architecture variants")
    variants_res = variants_path(dev, card)
    log("phase 3g: the mesh, the matmul FFT and the native decoder")
    mesh_res = mesh_path(dev, card)
    log("phase 3h: the Griffin-Lim geometries of the kernels' wide configuration")
    geometry_res = geometry_path(dev, card)
    log("phase 3i: the recurrent widths doubled (B3, B3' wide; B4, B6 in panels)")
    widths_res = widths_path(dev, card)
    log("phase 3j: BiGRUs of 752 (B3, B3' on the grid kind)")
    grid_res = widths_path(dev, card, GRID_ARCH, "grid", "3j")
    log("phase 3k: BiGRUs of 1420 (B3, B3' on the grid kind, streaming)")
    stream_res = widths_path(dev, card, STREAM_ARCH, "streamed", "3k")
    log("phase 3l: the per-shape gates of B4 and B6")
    gate_res = gate_path(dev, card)
    # Each kernel's launches come from the path it carries.
    own_path = {"gru_sequence_backward": "training", "fused_teacher_scan": "training",
                "reproject_frames_pallas": "serving", "fused_gl_iteration": "serving"}
    for k in kernels:
        by_path = {"synthesis": main_res["launches"][k["name"]],
                   "serving": serve_res["launches"][k["name"]],
                   "training": train_res["launches"][k["name"]],
                   "cli": cli_res["launches"][k["name"]],
                   "corpus": corpus_res["launches"][k["name"]],
                   "variants": variants_res["launches"].get(k["name"], 0),
                   "mesh": mesh_res["launches"][k["name"]],
                   "geometry": geometry_res["launches"][k["name"]]}
        k["launches"] = by_path[own_path.get(k["name"], "synthesis")]
        k["launches_by_path"] = by_path
    for rows, res, phase in ((wide, widths_res, "3i"), (grid, grid_res, "3j"),
                             (stream, stream_res, "3k")):
        for k in rows:  # launched by their phase only
            n = res["launches"].get(k["name"].rsplit("_", 1)[0], 0)
            k["launches"], k["launches_by_path"] = n, {f"phase {phase}": n}
            if not n:
                raise AssertionError(f"{k['name']} was not launched in phase {phase}")
    log(json.dumps({"main_path": main_res, "serving_path": serve_res,
                    "train_path": train_res, "cli_path": cli_res,
                    "corpus_path": corpus_res, "variants_path": variants_res,
                    "mesh_path": mesh_res, "geometry_path": geometry_res,
                    "widths_path": widths_res, "grid_path": grid_res,
                    "stream_path": stream_res, "gate_path": gate_res, "card": card}))
    log(card)
    log(json.dumps({"kernels": kernels + wide + grid + stream}))
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
