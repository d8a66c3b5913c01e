"""Kernels B2 and B5 built from two source trees, on one card, in one run.

    python3 -m sstts_torch.tools.compare_gl_builds --base OTHER/sstts_torch/csrc

Builds `gl_semi.cu` (B2) and `gl_fused.cu` (B5) from `--base` (the `csrc`
directory of another checkout, for example a parent commit unpacked with
`git archive`) and from this checkout, one `nvcc` per build, all started
together, into a temporary directory.  Each pair gets the same inputs at the
main path's shapes, (32, 800) frames with wp = 1152 and 2 hp = 2048 in bf16;
B2 runs classic and at momentum 0.99, B5 classic.  The script reports
whether the two builds give equal outputs (and, where they do not, the
largest difference and the share of elements that differ: two designs add
the same terms in another order), the registers and spills `ptxas` reports
for each, their times from CUDA events (one untimed round of every build,
then the order base, new, new, base, five times over) and the host's time
in each library's launch function.  Either tree
may hold the first port's kernels (a scratch slab per block of the grid) or
the TMA + wgmma ones (K-major weights, a slab per SM): the argument structs
share their leading fields, and the library says which scratch it wants.
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
import time
from pathlib import Path

import torch

from sstts_torch.dsp.gl_fused import _GlArgs, _GlFusedArgs, fused_scratch
from sstts_torch.dsp.gl_tiles import k_major
from sstts_torch.dsp.reproject import band_plan, padded_wss2d
from sstts_torch.ops import build
from sstts_torch.tools import card_line, time_ms


def host_us(launch, n: int = 200) -> float:
    """Host time of one call of a library's launch function (what it does
    before the kernel is queued: tensor maps, attributes, the launch), in
    microseconds; the card is kept busy but not waited for."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6

KERNELS = {"gl_semi": "sstts_gl_semi", "gl_fused": "sstts_gl_fused"}


def _build(dirs, tmp):
    procs = {}
    for tag, csrc in dirs.items():
        for name in KERNELS:
            out = Path(tmp) / f"{tag}-{name}.so"
            procs[(tag, name)] = (subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
                 str(Path(csrc) / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), out)
    libs, ptxas = {}, {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        ptxas[f"{key[0]}-{key[1]}"] = {"registers": [int(r) for r in regs],
                                       "spill_store_bytes": [int(b) for b in spills]}
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, KERNELS[key[1]])
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        if key[1] == "gl_fused" and hasattr(lib, "sstts_gl_fused_scratch_rows"):
            lib.sstts_gl_fused_scratch_rows.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.sstts_gl_fused_scratch_rows.restype = ctypes.c_int
        libs[key] = lib
    return libs, ptxas


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="csrc directory of the other tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_gl_builds: no CUDA device")
    dev = torch.device("cuda")
    Bt, T, wp, hp = 32, 800, 1152, 1024
    n_fft, hop, win = 2048, 275, 1102
    plan = band_plan(n_fft, hop, win, T, (T - 1) * hop)
    w_len, d_max = plan["w_len"], plan["d_max"]
    g = torch.Generator().manual_seed(5)
    bf = torch.bfloat16
    frames = torch.randn(Bt, T, wp, generator=g)
    frames[..., w_len:] = 0.0
    frames = frames.to(dev, bf)
    q = torch.randn(Bt, T, 2 * hp, generator=g).to(dev, bf)
    mag2 = torch.rand(Bt, T, 2 * hp, generator=g).to(dev, bf)
    w_inv = torch.randn(2 * hp, wp, generator=g) / 32
    w_inv[:, w_len:] = 0.0
    w_inv = w_inv.to(dev, bf)
    w_fwd = (torch.randn(wp, 2 * hp, generator=g) / 32).to(dev, bf)
    prev = torch.randn(Bt, T, 2 * hp, generator=g).to(dev, bf)
    wss2d = padded_wss2d(plan, wp, dev)
    w_fwd_t, w_inv_t = k_major(w_fwd), k_major(w_inv)
    stream = torch.cuda.current_stream().cuda_stream
    dirs = {"base": args.base, "new": str(build.CSRC)}
    with tempfile.TemporaryDirectory() as tmp:
        libs, ptxas = _build(dirs, tmp)
        launches, outs = {}, {}
        cases = [(key, key[1]) for key in libs]
        cases += [((tag, "gl_semi"), "gl_semi_momentum") for tag in dirs]
        for (tag, name), case in cases:
            lib = libs[(tag, name)]
            out = torch.empty_like(mag2)
            if case == "gl_semi":
                a = _GlArgs(frames.data_ptr(), mag2.data_ptr(), w_fwd.data_ptr(),
                            wss2d.data_ptr(), None, out.data_ptr(), None,
                            Bt, T, wp, hp, w_len, hop, d_max, 0.0,
                            w_fwd_t.data_ptr())
            elif case == "gl_semi_momentum":
                s_out = torch.empty_like(mag2)
                a = _GlArgs(frames.data_ptr(), mag2.data_ptr(), w_fwd.data_ptr(),
                            wss2d.data_ptr(), prev.data_ptr(), out.data_ptr(),
                            s_out.data_ptr(), Bt, T, wp, hp, w_len, hop, d_max, 0.99,
                            w_fwd_t.data_ptr())
                a._s_out = s_out
            else:
                if hasattr(lib, "sstts_gl_fused_scratch_rows"):  # a slab per block
                    rows = lib.sstts_gl_fused_scratch_rows(T, d_max)
                    scratch = torch.empty(Bt, rows, wp, dtype=torch.float32, device=dev)
                    flags = None
                else:  # a slab per SM, taken and given back by the blocks
                    scratch, flags = fused_scratch(dev, wp)
                a = _GlFusedArgs(q.data_ptr(), mag2.data_ptr(), w_inv.data_ptr(),
                                 w_fwd.data_ptr(), wss2d.data_ptr(), scratch.data_ptr(),
                                 out.data_ptr(), Bt, T, wp, hp, w_len, hop, d_max,
                                 scratch.shape[0], w_inv_t.data_ptr(),
                                 w_fwd_t.data_ptr(),
                                 None if flags is None else flags.data_ptr())
                a._scratch = scratch  # kept alive with the arguments
            a._out = out  # every build writes only its own output

            def launch(fn=getattr(lib, KERNELS[name]), a=a, key=(tag, case)):
                rc = fn(ctypes.byref(a), stream)
                if rc:
                    raise RuntimeError(f"{key}: CUDA error {rc}")

            launch()
            torch.cuda.synchronize()
            launches[(tag, case)], outs[(tag, case)] = launch, out.clone()
        for launch in launches.values():
            time_ms(launch)
        res = {"ptxas": ptxas}
        for name in ("gl_semi", "gl_semi_momentum", "gl_fused"):
            times = {"base": [], "new": []}
            for _ in range(5):
                for tag in ("base", "new", "new", "base"):
                    times[tag].append(time_ms(launches[(tag, name)]))
            base, new = statistics.mean(times["base"]), statistics.mean(times["new"])
            a32, b32 = outs[("base", name)].float(), outs[("new", name)].float()
            res[name] = {
                "outputs_equal": bool(torch.equal(a32, b32)),
                "max_abs_diff": float((a32 - b32).abs().max()),
                "differing": float((a32 != b32).float().mean()),
                "base_ms": times["base"], "new_ms": times["new"],
                "base_mean_ms": base, "new_mean_ms": new, "change": new / base - 1.0,
                "base_host_us": host_us(launches[("base", name)]),
                "new_host_us": host_us(launches[("new", name)]),
            }
    card = card_line()
    print(json.dumps({"compare_gl_builds": res, "shape": [Bt, T, wp, 2 * hp],
                      "card": card}))


if __name__ == "__main__":
    main()
