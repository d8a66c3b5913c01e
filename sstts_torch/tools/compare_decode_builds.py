"""Kernel B4 built from two source trees, on one card, in one run.

    python3 -m sstts_torch.tools.compare_decode_builds --base OTHER/sstts_torch/csrc

Builds `decoder.cu` from `--base` (the `csrc` directory of another
checkout, for example a parent commit unpacked with `git archive`) and from
this checkout, one `nvcc` each, started together, into a temporary
directory.  Either tree may hold the ring kernel that reads its prenet
keep masks from global memory (its `DecodeArgs` has `keep0` and `keep1`)
or the one that draws its dropout itself from a seed (`keep_bits`); the
source says which.  Both builds get the same inputs: `chip_smoke.py`'s two
cases at the default `Config()` from a seeded random init, (B=32, T=96,
S=160) in bf16 and S=20 in f32, prenet dropout on at one seed (the masks
build given `keep_masks` of that seed: the same bits), and the bf16 case
again with dropout off.  The script reports, for each case, each output's
largest difference between the builds and against `decode_steps_plain`,
whether `fin` is equal, the times from CUDA events (one untimed round, then
base, new, new, base, five times over) and what ptxas said of each build.
Prints one JSON line with the card's name and power limit.
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


def interface(src: str) -> str:
    """"masks" for a B4 source whose kernel reads keep masks from global
    memory, else "seed" (the current interface)."""
    return "masks" if "const float* keep0;" in src else "seed"


def compile_builds(jobs, tmp, binder=dec.bind):
    """Build every job, {key: (path of decoder.cu or another ring kernel's
    source, [-D settings])}, one `nvcc` each, all started together; {key:
    (CDLL, ptxas summary, interface)}, `binder` binding each library of the
    current interface."""
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
        kind = interface(Path(jobs[key][0]).read_text())
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")
        ptxas = {
            "registers": [int(r) for r in re.findall(r"Used (\d+) registers", log)],
            "spill_store_bytes": [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)],
        }
        lib = ctypes.CDLL(str(out))
        if kind == "seed":
            binder(lib)
        libs[key] = (lib, ptxas, kind)
    return libs


def decode_case(dev, S: int, dtype: torch.dtype, stop_threshold: float, *, B: int = 32,
                T: int = 96, cfg=None, seed: int = 3, dropout: bool = True):
    """`chip_smoke.py`'s decoder inputs: a seeded random init of `cfg` (the
    default `Config()`), memory and lengths from `seed`, the prenet dropout
    from the seed `seed + 1` (or off), min_steps 8."""
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
    with torch.no_grad():
        return dec.prepare_decode(cell, memory, mask, S, stop_threshold=stop_threshold,
                                  min_steps=8, seed=seed + 1 if dropout else None,
                                  matmul_dtype=dtype)


class _MaskDecodeArgs(ctypes.Structure):
    """`DecodeArgs` of the ring kernel that reads keep masks (S, B, P) f32
    {0, 1} from global memory, or NULL for no dropout."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("packed", "schedule", *dec._VECTORS, "memory", "keys", "mask",
                     "keep0", "keep1", "mel", "stop", "align", "fin")
    ] + [
        (name, ctypes.c_int)
        for name in ("B", "T", "S", "M", "P0", "P1", "Dm", "A", "Ha", "Hd", "r",
                     "min_steps", "n_chunks")
    ] + [("stop_threshold", ctypes.c_float), ("dropout_scale", ctypes.c_float)]


def launcher(lib, kind, p):
    """A function that launches `lib`'s kernel on `p` and returns its
    outputs, for either interface (`kind` as `compile_builds`): the masks
    kernel gets `keep_masks` of `p`'s seed, the bits the seed kernel
    draws."""
    if kind == "seed":
        return lambda: dec.launch(lib, p)
    dec.bind(lib)
    w, dev = p.w, p.memory.device
    B, T, _ = p.memory.shape
    S, r, M = p.max_steps, p.reduction, p.n_mels
    units = (w.prenet_w0.shape[1], w.prenet_w1.shape[1])
    keep = dec.keep_masks(p.seed, p.row0, S, B, units, p.rate, dev) or (None, None)
    keep = [None if k is None else k.contiguous() for k in keep]
    out = {
        "mel": torch.empty(B, S, r * M, device=dev),
        "stop": torch.empty(B, S, r, device=dev),
        "align": torch.empty(B, S, T, device=dev),
        "fin": torch.empty(B, S, device=dev),
    }
    ptrs = {"packed": p.packed, "schedule": p.schedule, "memory": dec.memory_panels(p.memory),
            "keys": dec._rows16(p.keys), "mask": p.maskf, "keep0": keep[0], "keep1": keep[1],
            **{n: getattr(w, n) for n in dec._VECTORS}, **out}
    drop = dec._dropout_fields(p)
    args = _MaskDecodeArgs(**dec._dims(p), n_chunks=p.schedule.shape[0],
                           stop_threshold=float(p.stop_threshold),
                           dropout_scale=drop["dropout_scale"])
    for name, t in ptrs.items():
        setattr(args, name, None if t is None else t.data_ptr())
    bf16 = int(w.attn_wx.dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        build.check(lib, lib.sstts_fused_decode(ctypes.byref(args), bf16, stream),
                    "fused_decode (masks)")
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
        res = {"ptxas": {k: v[1] for k, v in libs.items()},
               "interface": {k: v[2] for k, v in libs.items()}}
        for case, S, dt, thr, drop in (("S160-bf16", 160, torch.bfloat16, 1.1, True),
                                       ("S20-f32", 20, torch.float32, 0.5, True),
                                       ("S160-bf16-no-dropout", 160, torch.bfloat16, 1.1,
                                        False)):
            p = decode_case(dev, S, dt, thr, dropout=drop)
            with torch.no_grad():
                ref = dec.decode_steps_plain(p)
                launches = {tag: launcher(lib, kind, p) for tag, (lib, _, kind) in libs.items()}
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
                "bit_equal": all(torch.equal(outs["new"][k], outs["base"][k]) for k in OUTPUTS),
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
