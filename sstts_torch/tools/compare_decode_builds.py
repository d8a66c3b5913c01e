"""Kernel B4 built from two source trees, on one card, in one run.

    python3 -m sstts_torch.tools.compare_decode_builds --base OTHER/sstts_torch/csrc

Builds `decoder.cu` from `--base` (the `csrc` directory of another
checkout, for example a parent commit unpacked with `git archive`) and from
this checkout, one `nvcc` each, started together, into a temporary
directory.  Either tree may hold the first port's kernel (twelve matrix
pointers, each thread loading its weights from L2) or the ring kernel (one
packed buffer and a chunk schedule); the source says which (only the ring
kernel includes `stream.cuh`).  Both builds get the same inputs:
`chip_smoke.py`'s two cases at the default `Config()` from a seeded random
init, (B=32, T=96, S=160) in bf16 and S=20 in f32, prenet dropout on.  The
script reports, for each case, each output's largest difference between the
builds and against `decode_steps_plain`, whether `fin` is equal, the times
from CUDA events (one untimed round, then base, new, new, base, five times
over) and what ptxas said of each build.  Prints one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from sstts_torch.ops import build
from sstts_torch.ops import decoder as dec
from sstts_torch.tools import card_line, time_ms

OUTPUTS = ("mel", "stop", "align", "fin")


def compile_builds(jobs, tmp, binder=dec.bind):
    """Build every job, {key: (path of decoder.cu or another ring kernel's
    source, [-D settings])}, one `nvcc` each, all started together; {key:
    (CDLL, ptxas summary, ring)}, ring True for the ring kernel's interface
    (then `binder` binds the library)."""
    procs = {}
    for key, (src, defines) in jobs.items():
        out = Path(tmp) / f"{Path(src).stem}-{abs(hash(key))}.so"
        procs[key] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
             "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), out)
    libs = {}
    for key, (proc, out) in procs.items():
        ring = '#include "stream.cuh"' in Path(jobs[key][0]).read_text()
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")
        ptxas = {
            "registers": [int(r) for r in re.findall(r"Used (\d+) registers", log)],
            "spill_store_bytes": [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)],
        }
        lib = ctypes.CDLL(str(out))
        if ring:
            binder(lib)
        libs[key] = (lib, ptxas, ring)
    return libs


def decode_case(dev, S: int, dtype: torch.dtype, stop_threshold: float, *, B: int = 32,
                T: int = 96, cfg=None, seed: int = 3):
    """`chip_smoke.py`'s decoder inputs: a seeded random init of `cfg` (the
    default `Config()`), memory and lengths from `seed`, dropout keep masks
    from `seed + 1`, min_steps 8."""
    from sstts_torch.config import Config
    from sstts_torch.model.tacotron import Tacotron, init_state_dict

    cfg = cfg or Config()
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=2))
    cell = model.decoder_cell.to(dev).eval()
    Dm = 2 * cfg.arch.encoder_gru_units
    g = torch.Generator().manual_seed(seed)
    memory = (0.5 * torch.randn(B, T, Dm, generator=g)).to(dev)
    lengths = torch.randint(min(40, T), T + 1, (B,), generator=g).to(dev)
    mask = torch.arange(T, device=dev)[None] < lengths[:, None]
    gdev = torch.Generator(device=dev).manual_seed(seed + 1)
    keep = dec.draw_keep_masks(S, B, cfg.arch.prenet_units, 0.5, gdev, dev)
    with torch.no_grad():
        return dec.prepare_decode(cell, memory, mask, S, stop_threshold=stop_threshold,
                                  min_steps=8, keep=keep, matmul_dtype=dtype)


class _FirstDecodeArgs(ctypes.Structure):
    """`DecodeArgs` of the first port's kernel: every matrix and vector by
    its own pointer, in `DecoderWeights` order."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (*dec.DecoderWeights._fields, "memory", "keys", "mask", "keep0",
                     "keep1", "mel", "stop", "align", "fin")
    ] + [
        (name, ctypes.c_int)
        for name in ("B", "T", "S", "M", "P0", "P1", "Dm", "A", "Ha", "Hd", "r",
                     "min_steps")
    ] + [("stop_threshold", ctypes.c_float), ("dropout_scale", ctypes.c_float)]


def launcher(lib, ring, p):
    """A function that launches `lib`'s kernel on `p` and returns its
    outputs, for either kernel interface (`ring` as `compile_builds`)."""
    if ring:
        return lambda: dec.launch(lib, p)
    for fn, (argtypes, restype) in {
        "sstts_fused_decode": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
        "sstts_decode_smem_bytes": ([ctypes.c_void_p], ctypes.c_int),
    }.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    w, dev = p.w, p.memory.device
    B, T, Dm = p.memory.shape
    S, r, M = p.max_steps, p.reduction, p.n_mels
    out = {
        "mel": torch.empty(B, S, r * M, device=dev),
        "stop": torch.empty(B, S, r, device=dev),
        "align": torch.empty(B, S, T, device=dev),
        "fin": torch.empty(B, S, device=dev),
    }
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    args = _FirstDecodeArgs(
        *[ptr(t) for t in w], ptr(p.memory), ptr(p.keys), ptr(p.maskf), ptr(p.keep0),
        ptr(p.keep1), *[ptr(out[k]) for k in OUTPUTS],
        B, T, S, M, w.prenet_w0.shape[1], w.prenet_w1.shape[1], Dm, p.keys.shape[-1],
        w.attn_wh.shape[0], w.gru0_wh.shape[0], r, int(p.min_steps),
        float(p.stop_threshold), float(p.dropout_scale),
    )
    bf16 = int(w.attn_wx.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = lib.sstts_fused_decode(ctypes.byref(args), bf16, stream)
        if rc:
            raise RuntimeError(f"fused_decode (first kernel): CUDA error {rc}")
        return out

    return launch


def max_diffs(a, b):
    return {k: float((a[k].float() - b[k].float()).abs().max()) for k in OUTPUTS}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="csrc directory of the other tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_decode_builds: no CUDA device")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_builds({
            "base": (Path(args.base) / "decoder.cu", []),
            "new": (build.CSRC / "decoder.cu", []),
        }, tmp)
        res = {"ptxas": {k: v[1] for k, v in libs.items()}}
        for case, S, dt, thr in (("S160-bf16", 160, torch.bfloat16, 1.1),
                                 ("S20-f32", 20, torch.float32, 0.5)):
            p = decode_case(dev, S, dt, thr)
            with torch.no_grad():
                ref = dec.decode_steps_plain(p)
                launches = {tag: launcher(lib, ring, p) for tag, (lib, _, ring) in libs.items()}
                outs = {tag: {k: v.clone() for k, v in fn().items()}
                        for tag, fn in launches.items()}
                torch.cuda.synchronize()
                for fn in launches.values():
                    time_ms(fn, iters=3, reps=2)
                times = {"base": [], "new": []}
                for _ in range(5):
                    for tag in ("base", "new", "new", "base"):
                        times[tag].append(time_ms(launches[tag], iters=3, reps=3))
            base, new = statistics.mean(times["base"]), statistics.mean(times["new"])
            res[case] = {
                "new_vs_base": max_diffs(outs["new"], outs["base"]),
                "base_vs_plain": max_diffs(outs["base"], ref),
                "new_vs_plain": max_diffs(outs["new"], ref),
                "fin_equal": {tag: bool(torch.equal(o["fin"], ref["fin"]))
                              for tag, o in outs.items()},
                "base_ms": times["base"], "new_ms": times["new"],
                "base_mean_ms": base, "new_mean_ms": new, "change": new / base - 1.0,
            }
    print(json.dumps({"compare_decode_builds": res, "card": card_line()}))


if __name__ == "__main__":
    main()
