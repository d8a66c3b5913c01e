"""Kernels B2 and B5 built from two source trees, on one card, in one run.

    python3 -m sstts_torch.tools.compare_gl_builds --base OTHER/sstts_torch/csrc \
        [--geometry defaults|16kHz|24kHz|hop10ms|hop5ms|hop3ms|44kHz] [--dtype bf16|f32]

Builds `gl_semi.cu` (B2) and `gl_fused.cu` (B5) from `--base` (the `csrc`
directory of another checkout, for example a parent commit unpacked with
`git archive`) and from this checkout, one `nvcc` per build, all started
together, into a temporary directory.  Each pair gets the same inputs at
(32, 800) frames of the geometry and loop dtype asked for (default: the
defaults in bf16, wp = 1152 and 2 hp = 2048; `tools/gl_launch.py` has the
geometries), in the tile configuration this tree's wrappers pick there
(`gl_tiles.config`); B2 runs classic and at momentum 0.99, B5 classic.  A
build without that configuration (a tree from before the wide one, at a
geometry or dtype only the wide one takes) is left out and the other timed
alone.  The script reports whether the two builds give equal outputs (and,
where they do not, the largest difference and the share of elements that
differ: two designs add the same terms in another order), the registers and
spills `ptxas` reports for each, their times from CUDA events (one untimed
round of every build, then the order base, new, new, base, five times over)
and the host's time in each library's launch function.  Either tree may hold
the first port's kernels (a scratch slab per block of the grid) or the TMA +
wgmma ones (K-major weights, a slab per SM): the argument structs share
their leading fields, and the library says which scratch it wants.  Prints
one JSON line with the card's name and power limit.
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

from sstts_torch.ops import build
from sstts_torch.tools import card_line, gl_launch, time_ms


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

KERNELS = ("gl_semi", "gl_fused")


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
        libs[key] = gl_launch.bind(ctypes.CDLL(str(out)))
    return libs, ptxas


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="csrc directory of the other tree")
    ap.add_argument("--geometry", default="defaults", choices=sorted(gl_launch.GEOMETRIES))
    ap.add_argument("--dtype", default="bf16", choices=sorted(gl_launch.DTYPES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_gl_builds: no CUDA device")
    dev = torch.device("cuda")
    x = gl_launch.inputs(dev, args.geometry, gl_launch.DTYPES[args.dtype])
    dirs = {"base": args.base, "new": str(build.CSRC)}
    with tempfile.TemporaryDirectory() as tmp:
        libs, ptxas = _build(dirs, tmp)
        launches, outs = {}, {}
        for tag in dirs:
            for case in gl_launch.CASES:
                lib = libs[(tag, "gl_fused" if case == "gl_fused" else "gl_semi")]
                got = gl_launch.launcher(lib, case, x, dev)
                if got is None:
                    continue
                launch, out = got
                launch()
                torch.cuda.synchronize()
                launches[(tag, case)], outs[(tag, case)] = launch, out.clone()
        for launch in launches.values():
            time_ms(launch)
        res = {"ptxas": ptxas}
        for name in gl_launch.CASES:
            tags = [tag for tag in dirs if (tag, name) in launches]
            times = {tag: [] for tag in tags}
            for _ in range(5):
                for tag in ("base", "new", "new", "base"):
                    if tag in times:
                        times[tag].append(time_ms(launches[(tag, name)]))
            r = {"config": gl_launch.config(name, x)}
            for tag in tags:
                r[f"{tag}_ms"] = times[tag]
                r[f"{tag}_mean_ms"] = statistics.mean(times[tag])
                r[f"{tag}_host_us"] = host_us(launches[(tag, name)])
            if len(tags) == 2:
                a32, b32 = outs[("base", name)].float(), outs[("new", name)].float()
                r.update(outputs_equal=bool(torch.equal(a32, b32)),
                         max_abs_diff=float((a32 - b32).abs().max()),
                         differing=float((a32 != b32).float().mean()),
                         change=r["new_mean_ms"] / r["base_mean_ms"] - 1.0)
            res[name] = r
    card = card_line()
    print(json.dumps({"compare_gl_builds": res, "geometry": args.geometry,
                      "dtype": args.dtype, "shape": [x["Bt"], x["T"], x["wp"], 2 * x["hp"]],
                      "card": card}))


if __name__ == "__main__":
    main()
