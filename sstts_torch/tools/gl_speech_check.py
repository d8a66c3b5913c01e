"""Kernels B2 and B5 on magnitudes of in-repo audio, held to their plain
versions at every launch of whole Griffin-Lim loops, on the card.

    python3 -m sstts_torch.tools.gl_speech_check [--iters 60] [--utterances 32]
        [--geometry default 24kHz 44kHz] [--chained-lanes N]

Run from the repository's root: it imports `chip_smoke` (`hold_gl`,
`b5_reference`, the geometries).  The audio is `sstts_torch/data/synthetic.py`'s
corpus (one harmonic tone a character, a noise floor, zero-padded to 800
frames: silent tails, deep valleys between the harmonics), its normalized
linear spectrogram from the port's STFT (`dsp.ops.wav_to_features`), and
the loop the Synthesizer runs on it (`dsp.griffin_lim.spectrogram_to_wav`)
at the default geometry (22.05 kHz, n_fft 2048), at 24 kHz and at 44.1 kHz
with n_fft 2048: "semi" (B2) classic and at momentum 0.99, and "fused" (B5)
classic.  Every launch of each loop is held by `chip_smoke.hold_gl` to its
plain version on its own inputs (B5 to `chip_smoke.b5_reference`, GEMM1's
sums exact), and both the kernel and that plain version are held by the
same limits to the exact sums (every product in float64, the spectrum
rounded once to f32 before the renorm).  Each output past one bf16 step
of the largest value (hold_gl's limit for B2) is located by |s|, the
magnitude of its bin's exact spectrum before the renorm.  Then each loop
is timed whole (CUDA events, no checks).  `--chained-lanes N` builds the
kernels from a copy of `csrc/` whose wide GEMM2 chains its bf16 sums only
up to N lanes of support and compensates them past it (`kChainedLanes` in
`gl_wide.cuh`, 2048 as built).  Prints a line a loop and one JSON line
with the counts, the loops' times and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import shutil
import statistics
import tempfile
from pathlib import Path

import numpy as np
import torch

from sstts_torch.config import Config
from sstts_torch.data.synthetic import make_utterances, synth_waveform
from sstts_torch.dsp import gl_fused as gl
from sstts_torch.dsp import ops as dsp_ops
from sstts_torch.dsp.griffin_lim import spectrogram_to_wav
from sstts_torch.dsp.reproject import shift_add_rows
from sstts_torch.ops import build
from sstts_torch.synthesize import exact_f32
from sstts_torch.tools import card_line, time_ms

#: The lower edges of the |s| bins outputs past the limit are counted in.
DECADES = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0)


def geometries():
    """(name, DatasetConfig fields) of the checked geometries."""
    import chip_smoke

    return [("default", {}), ("24kHz", chip_smoke.DS_24K), ("44kHz", chip_smoke.DS_44K)]


def exact_spectrum(kernel: str, args) -> torch.Tensor:
    """The spectrum before the renorm from exact sums: every product in
    float64 over the operands the kernel reads, rounded once to f32 (B2
    with momentum: the extrapolated spectrum, as the plain version forms
    it in f32)."""
    if kernel == "B2":
        frames, mag2, w_fwd, wss2d, w_len, hop, d_max, prev, momentum = args[:9]
        dtype = frames.dtype
    else:
        q, mag2, w_inv, w_fwd, wss2d, w_len, hop, d_max = args[:8]
        dtype, prev, momentum = q.dtype, None, 0.0
        frames = (q.double() @ w_inv.double()).float()
    acc = shift_add_rows(frames, w_len, hop, d_max, 0, frames.shape[-2])
    s32 = ((acc * wss2d).to(dtype).double() @ w_fwd.double()).float()
    if prev is not None and momentum > 0.0:
        s32 = s32 + float(np.float32(momentum)) * (s32 - prev.float())
    return s32


def spectrum_abs(s32: torch.Tensor) -> torch.Tensor:
    """|s| of every output lane: both lanes of a bin carry the bin's |s|."""
    hp = s32.shape[-1] // 2
    mag = torch.sqrt(s32[..., :hp] ** 2 + s32[..., hp:] ** 2)
    return torch.cat([mag, mag], -1)


def _holds(kernel: str, case: str, a, b) -> bool:
    """Whether `hold_gl` takes `a` against `b`."""
    import chip_smoke

    try:
        chip_smoke.hold_gl(kernel, case, a, b)
        return True
    except AssertionError:
        return False


@contextlib.contextmanager
def held_launches(kernel: str, record: dict):
    """Within the block, every launch of B2 (`gl_fused._kernel`) or B5
    (`gl_fused._fused_kernel`) is held to its plain version on its own
    inputs right after it; `record` gathers the counts."""
    import chip_smoke

    name = {"B2": "_kernel", "B5": "_fused_kernel"}[kernel]
    orig = getattr(gl, name)

    def spy(*args):
        out = orig(*args)
        dev = args[0].device
        with exact_f32(dev):
            if kernel == "B2":
                plain = gl.reproject_analyze_plain(*args[:9])[0]
                got = out[0]
            else:
                plain, got = chip_smoke.b5_reference(*args[:8]), out
            s32 = exact_spectrum(kernel, args)
            exact = gl.renorm(s32, args[1], s32.shape[-1] // 2, got.dtype)
            s_abs = spectrum_abs(s32)
        record["launches"] += 1
        tag = f"{record['case']}-{record['launches']}"
        for key, a, b in (("missed", got, plain), ("missed_vs_exact", got, exact),
                          ("plain_missed_vs_exact", plain, exact)):
            if not _holds(kernel, f"{tag}-{key}", a, b):
                record[key].append(record["launches"])
        record["outputs"] += got.numel()
        for key, a, b in (("differing", got, plain), ("differing_vs_exact", got, exact),
                          ("plain_differing_vs_exact", plain, exact)):
            record[key] += int((a != b).sum())
        for key, b in (("past", plain), ("past_vs_exact", exact)):
            d = (got.float() - b.float()).abs()
            past = d > 2.0**-7 * float(b.float().abs().max())
            record[key] += int(past.sum())
            if key == "past_vs_exact":
                continue
            at = s_abs[past]
            for i, lo in enumerate(DECADES[:-1]):
                hi = DECADES[i + 1] if i + 2 < len(DECADES) else float("inf")
                record["past_by_s"][i] += int(((at >= lo) & (at < hi)).sum())
            if at.numel():
                record["smallest_s_past"] = min(record["smallest_s_past"], float(at.min()))
                record["largest_s_past"] = max(record["largest_s_past"], float(at.max()))
        return out

    setattr(gl, name, spy)
    try:
        yield
    finally:
        setattr(gl, name, orig)


def held_loop(kernel: str, case: str, lin, cfg, dev) -> dict:
    """`spectrogram_to_wav(lin, cfg)` with every launch of `kernel` held
    (`held_launches`); the record of the counts, and whether the audio is
    finite."""
    record = {"case": case, "kernel": kernel, "launches": 0, "missed": [],
              "missed_vs_exact": [], "plain_missed_vs_exact": [], "outputs": 0,
              "differing": 0, "differing_vs_exact": 0, "plain_differing_vs_exact": 0,
              "past": 0, "past_vs_exact": 0, "past_by_s": [0] * (len(DECADES) - 1),
              "smallest_s_past": float("inf"), "largest_s_past": 0.0}
    length = (lin.shape[1] - 1) * cfg.dataset.hop_len
    with torch.inference_mode(), exact_f32(dev), held_launches(kernel, record):
        wav = spectrogram_to_wav(lin, cfg, length)
    torch.cuda.synchronize()
    record["finite"] = bool(torch.isfinite(wav).all())
    if not record["past"]:
        record["smallest_s_past"] = record["largest_s_past"] = None
    return record


def linear_of_corpus(ds, n: int, frames: int, dev) -> torch.Tensor:
    """The normalized linear spectrograms (n, frames, bins) of the first
    `n` synthetic utterances, zero-padded (or cut) to `frames` frames."""
    length = (frames - 1) * ds.hop_len
    y = np.zeros((n, length), np.float32)
    for i, u in enumerate(make_utterances(n, ds, 10, 16)):
        w = synth_waveform(u.uid, u.text, ds)[:length]
        y[i, : len(w)] = w
    lin, _ = dsp_ops.wav_to_features(torch.as_tensor(y, device=dev), ds)
    return lin[:, :frames]


def use_chained_lanes(lanes: int, tmp: str) -> None:
    """Build this process's kernels from a copy of `csrc/` in `tmp` whose
    wide GEMM2 chains its bf16 sums up to `lanes` lanes of support."""
    src = Path(tmp) / "csrc"
    shutil.copytree(build.CSRC, src)
    wide = src / "gl_wide.cuh"
    text, n = re.subn(r"constexpr int kChainedLanes = \d+;",
                      f"constexpr int kChainedLanes = {lanes};", wide.read_text())
    if n != 1:
        raise SystemExit("gl_speech_check: kChainedLanes not found in gl_wide.cuh")
    wide.write_text(text)
    build.CSRC, build.BUILD_DIR = src, Path(tmp) / "build"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--utterances", type=int, default=32)
    ap.add_argument("--frames", type=int, default=800)
    ap.add_argument("--geometry", nargs="*", help="names of `geometries()` (default: all)")
    ap.add_argument("--chained-lanes", type=int)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gl_speech_check: no CUDA device")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        if args.chained_lanes is not None:
            use_chained_lanes(args.chained_lanes, tmp)
        res = run(dev, args)
    print(json.dumps({"gl_speech_check": res}))


def run(dev, args) -> dict:
    res = {"card": card_line(), "chained_lanes": args.chained_lanes,
           "decades": list(DECADES[:-1]), "loops": []}
    for geo, fields in geometries():
        if args.geometry and geo not in args.geometry:
            continue
        base = Config()
        ds = dataclasses.replace(base.dataset, **fields)
        lin = linear_of_corpus(ds, args.utterances, args.frames, dev)
        length = (lin.shape[1] - 1) * ds.hop_len
        for impl, momentum, kernel in (("semi", 0.0, "B2"), ("semi", 0.99, "B2"),
                                       ("fused", 0.0, "B5")):
            cfg = base.replace(dataset=ds, inference=dataclasses.replace(
                base.inference, griffin_lim_iter_impl=impl, griffin_lim_momentum=momentum,
                griffin_lim_iters=args.iters))
            case = f"{geo}-{impl}-m{momentum}"
            record = held_loop(kernel, case, lin, cfg, dev)
            with torch.inference_mode(), exact_f32(dev):
                record["loop_ms"] = [time_ms(lambda: spectrogram_to_wav(lin, cfg, length),
                                             iters=1, reps=3) for _ in range(3)]
            n = max(1, record["outputs"])
            print(f"{case}: {record['launches']} launches; past hold_gl against the plain "
                  f"version {len(record['missed'])}, against exact sums "
                  f"{len(record['missed_vs_exact'])} (the plain version itself "
                  f"{len(record['plain_missed_vs_exact'])}); differing "
                  f"{record['differing'] / n:.3e} / {record['differing_vs_exact'] / n:.3e} "
                  f"(plain {record['plain_differing_vs_exact'] / n:.3e}); past one bf16 step "
                  f"{record['past']} / {record['past_vs_exact']} of {record['outputs']} (by "
                  f"|s| decade {record['past_by_s']}); loop "
                  f"{statistics.median(record['loop_ms']):.3f} ms", flush=True)
            res["loops"].append(record)
    res["launches"] = sum(r["launches"] for r in res["loops"])
    res["missed"] = sum(len(r["missed"]) for r in res["loops"])
    return res


if __name__ == "__main__":
    main()
