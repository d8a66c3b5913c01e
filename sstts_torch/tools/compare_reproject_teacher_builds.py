"""Kernels B1 and B6 built from two source trees, on one card, in one run.

    python3 -m sstts_torch.tools.compare_reproject_teacher_builds --base OTHER/sstts_torch/csrc

Builds `reproject.cu` (B1) and `teacher.cu` (B6) from `--base` (the `csrc`
directory of another checkout, for example a parent commit unpacked with
`git archive`) and from this checkout, one `nvcc` per build, all started
together, into a temporary directory.  Either tree may hold the first
port's kernels (B1: rows staged a block at a time, the mirror runs applied
after it in torch; B6: every thread loading its weights from L2, the
matrices by their own pointers) or the redesigned ones (B1: a ring of row
stages with the mirror runs in the launch; B6: the bulk-copy ring and the
shared chain of B4); the sources say which.  Each pair gets the same
inputs: B1 the split iteration's (32, 800) frames at wp = 1152 (bf16 and
f32, lanes beyond the window support holding noise), B6 the train step's
(B=32, T=128, S=103) in bf16 and S=20 in f32.  The script reports each
output's largest difference between the builds and against the plain
version, the registers and spills `ptxas` reports for each build, and the
times from CUDA events (one untimed round of every build, then the order
base, new, new, base, five times over); B1's "base" is timed with its
mirror runs, as its wrapper ran it.  Prints one JSON line with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import tempfile
from pathlib import Path

import torch

from sstts_torch.dsp import reproject as rp
from sstts_torch.ops import build
from sstts_torch.ops import teacher as tops
from sstts_torch.tools import card_line, time_ms
from sstts_torch.tools.ablate_decode import teacher_case
from sstts_torch.tools.compare_decode_builds import compile_builds


class _FirstReprojectArgs(ctypes.Structure):
    """`ReprojectArgs` of the first port's B1 kernel."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("frames", "wss2d", "out")] + [
        (n, ctypes.c_int) for n in ("Bt", "T", "wp", "w_len", "hop", "d_max")
    ]


class _FirstTeacherArgs(ctypes.Structure):
    """`TeacherArgs` of the first port's B6 kernel: every matrix and vector
    by its own pointer, in `TeacherWeights` order."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (*tops.TeacherWeights._fields, "pre", "memory", "keys", "mask", "xs",
                     "align")
    ] + [(name, ctypes.c_int) for name in ("B", "T", "S", "P1", "Dm", "A", "Ha", "Hd")]


def _signatures(lib, sigs):
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    return lib


def reproject_launcher(lib, new, f3, wss2d, plan, hop):
    """A function that runs `lib`'s B1 with its mirror runs on f3."""
    w_len, d_max, runs = plan["w_len"], plan["d_max"], plan["runs"]
    if new:
        return lambda: rp.launch(lib, f3, wss2d, w_len, hop, d_max, runs)
    _signatures(lib, {"sstts_reproject": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
                                          ctypes.c_int)})
    bt, n_frames, wp = f3.shape
    stream = torch.cuda.current_stream(f3.device).cuda_stream

    def launch():
        out = torch.empty_like(f3)
        args = _FirstReprojectArgs(f3.data_ptr(), wss2d.data_ptr(), out.data_ptr(),
                                   bt, n_frames, wp, w_len, hop, d_max)
        rc = lib.sstts_reproject(ctypes.byref(args), int(f3.dtype == torch.bfloat16), stream)
        if rc:
            raise RuntimeError(f"reproject (first kernel): CUDA error {rc}")
        return rp.apply_mirror_runs(out, runs)

    return launch


def teacher_launcher(lib, new, w, pre, memory, keys, maskf, dt):
    """A function that runs `lib`'s B6 on live weights."""
    if new:
        return lambda: tops.launch(lib, w, pre, memory, keys, maskf, dt)
    _signatures(lib, {
        "sstts_fused_teacher_scan": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
                                     ctypes.c_int),
    })
    dev = pre.device
    d = tops.dims(w, pre, memory, keys)
    wc = [t.detach().to(dt if t.dim() == 2 else torch.float32).contiguous() for t in w]
    ins = [pre.float().contiguous(), memory.to(dt).contiguous(), keys.to(dt).contiguous(),
           maskf.float().contiguous()]
    xs = torch.empty(d["B"], d["S"], d["Hd"], device=dev)
    align = torch.empty(d["B"], d["S"], d["T"], device=dev)
    args = _FirstTeacherArgs(*[t.data_ptr() for t in (*wc, *ins, xs, align)], *d.values())
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = lib.sstts_fused_teacher_scan(ctypes.byref(args), int(dt == torch.bfloat16),
                                          stream)
        if rc:
            raise RuntimeError(f"fused_teacher_scan (first kernel): CUDA error {rc}")
        return xs, align

    return launch


def in_turns(launches, iters):
    """One untimed round, then base, new, new, base five times over."""
    for fn in launches.values():
        time_ms(fn, iters=iters, reps=2)
    times = {"base": [], "new": []}
    for _ in range(5):
        for tag in ("base", "new", "new", "base"):
            times[tag].append(time_ms(launches[tag], iters=iters, reps=3))
    base, new = statistics.mean(times["base"]), statistics.mean(times["new"])
    return {"base_ms": times["base"], "new_ms": times["new"], "base_mean_ms": base,
            "new_mean_ms": new, "change": new / base - 1.0}


def diff(a, b):
    return float((a.float() - b.float()).abs().max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="csrc directory of the other tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_reproject_teacher_builds: no CUDA device")
    dev = torch.device("cuda")
    base = Path(args.base)
    jobs = {(k, tag): (root / f"{k}.cu", [])
            for k in ("reproject", "teacher") for tag, root in (("base", base),
                                                                ("new", build.CSRC))}
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for (k, tag), (lib, ptxas, _) in compile_builds(jobs, tmp, lambda lib: lib).items():
            text = jobs[(k, tag)][0].read_text()
            new = "const int* runs;" in text if k == "reproject" else "stream.cuh" in text
            if new:
                (rp.bind if k == "reproject" else tops.bind)(lib)
            libs[(k, tag)] = (lib, ptxas, new)
        res["ptxas"] = {f"{k}-{tag}": v[1] for (k, tag), v in libs.items()}
        # B1 at the split iteration's shapes.
        from sstts_torch.config import Config

        ds = Config().dataset
        T = 800
        length = (T - 1) * ds.hop_len
        geom = (ds.n_fft, ds.hop_len, ds.win_len, length)
        plan = rp.band_plan(*geom[:3], T, length)
        wp = -(-plan["w_len"] // 128) * 128
        g = torch.Generator().manual_seed(6)
        frames = torch.randn(32, T, wp, generator=g)
        wss2d = rp.padded_wss2d(plan, wp, dev)
        for dt in (torch.bfloat16, torch.float32):
            f3 = frames.to(dev, dt)
            ref = rp.reproject_frames_plain(f3, *geom, wss2d)
            launches = {tag: reproject_launcher(libs[("reproject", tag)][0],
                                                libs[("reproject", tag)][2], f3, wss2d,
                                                plan, ds.hop_len)
                        for tag in ("base", "new")}
            with torch.no_grad():
                outs = {tag: fn().clone() for tag, fn in launches.items()}
                torch.cuda.synchronize()
                case = f"reproject-{str(dt).split('.')[-1]}"
                res[case] = {
                    "new_vs_base": diff(outs["new"], outs["base"]),
                    "bit_equal": {tag: bool(torch.equal(o, ref)) for tag, o in outs.items()},
                    "base_vs_plain": diff(outs["base"], ref),
                    "new_vs_plain": diff(outs["new"], ref),
                    **in_turns(launches, 20),
                }
        # B6 at the train step's shape (bf16) and S=20 in f32.
        for S, dt in ((103, torch.bfloat16), (20, torch.float32)):
            w, pre, memory, keys, maskf = teacher_case(dev, S=S)
            with torch.no_grad():
                ref = tops.fused_teacher_scan_plain(w, pre, memory, keys, maskf, dt)
                launches = {tag: teacher_launcher(libs[("teacher", tag)][0],
                                                  libs[("teacher", tag)][2], w, pre, memory,
                                                  keys, maskf, dt)
                            for tag in ("base", "new")}
                outs = {tag: [o.clone() for o in fn()] for tag, fn in launches.items()}
                torch.cuda.synchronize()
                case = f"teacher-S{S}-{str(dt).split('.')[-1]}"
                res[case] = {
                    "new_vs_base": {"xs": diff(outs["new"][0], outs["base"][0]),
                                    "align": diff(outs["new"][1], outs["base"][1])},
                    "base_vs_plain": {"xs": diff(outs["base"][0], ref[0]),
                                      "align": diff(outs["base"][1], ref[1])},
                    "new_vs_plain": {"xs": diff(outs["new"][0], ref[0]),
                                     "align": diff(outs["new"][1], ref[1])},
                    **in_turns(launches, 3),
                }
    print(json.dumps({"compare_reproject_teacher_builds": res, "card": card_line()}))


if __name__ == "__main__":
    main()
