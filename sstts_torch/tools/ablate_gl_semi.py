"""Stage breakdown of the Griffin-Lim kernels B2 and B5 on the card.

    python3 -m sstts_torch.tools.ablate_gl_semi [--geometry NAME] [--dtype bf16|f32]

Builds `sstts_torch/csrc/gl_semi.cu` and `gl_fused.cu` once per stage mask
(SSTTS_ABLATE: 1 skips the A panel's loads and sums, 2 GEMM2's loads and
wgmma, 4 the epilogue's loads and stores; for B5 also 8 GEMM1's loads and
wgmma and 16 the stores of its f32 slab; one `nvcc` per mask, all started
together, into a temporary directory) and times each build at the main
path's shape, (32, 800, 1152) -> (32, 800, 2048) bf16, classic iteration,
with CUDA events (or another geometry of `tools/gl_launch.py` where the
whole panel takes it, `--geometry`).  The stages of a block overlap (and so do the blocks of a
launch), so the times do not add up: a mask says what the kernel costs
without that stage's work.  The whole kernels are also built and timed with
clusters of 1, 2 and 4 blocks (SSTTS_CLUSTER; 2 is what every other build
uses).  A build with stages skipped computes garbage;
only its time means anything.  The stage masks and cluster sizes are the
whole-panel configuration's; at a geometry or loop dtype where the wrappers
pick the wide configuration (`--geometry`, `--dtype`: `tools/gl_launch.py`;
`gl_tiles.config`) the script times this tree's build of each whole kernel
there instead (B2 classic and at momentum 0.99, B5), at (32, 800) frames.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from sstts_torch.ops import build
from sstts_torch.tools import card_line, gl_launch, time_ms

MASKS = {
    0: "full",
    1: "without A panel",
    2: "without GEMM",
    4: "without epilogue",
    6: "A panel only",
    5: "GEMM only",
    3: "epilogue only",
    7: "launch and barriers only",
}

CLUSTERS = (1, 2, 4)

FUSED_MASKS = {
    0: "full",
    8: "without GEMM1",
    16: "without the slab's stores",
    24: "tail only",
    7: "GEMM1 and slab only",
    23: "GEMM1 only",
}


def wide(geometry: str, dtype: str) -> None:
    """The whole wide kernels of this tree at a geometry and loop dtype."""
    dev = torch.device("cuda")
    x = gl_launch.inputs(dev, geometry, gl_launch.DTYPES[dtype])
    res = {}
    for case in gl_launch.CASES:
        lib = gl_launch.bind(build.load("gl_fused" if case == "gl_fused" else "gl_semi", {}))
        launch, _ = gl_launch.launcher(lib, case, x, dev)
        res[f"{case} ({gl_launch.config(case, x)})"] = time_ms(launch)
    print(json.dumps({"gl_wide_ms": res, "geometry": geometry, "dtype": dtype,
                      "shape": [x["Bt"], x["T"], x["wp"], 2 * x["hp"]], "card": card_line()}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geometry", default="defaults", choices=sorted(gl_launch.GEOMETRIES))
    ap.add_argument("--dtype", default="bf16", choices=sorted(gl_launch.DTYPES))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gl_semi: no CUDA device")
    x = gl_launch.inputs("cpu", opts.geometry, gl_launch.DTYPES[opts.dtype], Bt=1, T=2)
    if any(gl_launch.config(case, x) == "wide" for case in gl_launch.CASES):
        return wide(opts.geometry, opts.dtype)
    with tempfile.TemporaryDirectory() as tmp:
        # (kernel, define, value) -> nvcc: a build per stage mask and per
        # cluster size
        procs = {
            (name, define, v): subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, f"-D{define}={v}",
                 "-o", str(Path(tmp) / f"{name}-{define}-{v}.so"),
                 str(build.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name, masks in (("gl_semi", MASKS), ("gl_fused", FUSED_MASKS))
            for define, values in (("SSTTS_ABLATE", masks), ("SSTTS_CLUSTER", CLUSTERS))
            for v in values
        }
        for key, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc {key[0]} -D{key[1]}={key[2]} failed:\n{log}")
        dev = torch.device("cuda")
        x = gl_launch.inputs(dev, opts.geometry, gl_launch.DTYPES[opts.dtype])
        res = {"gl_semi": {}, "gl_fused": {}}
        for name, define, v in procs:
            lib = gl_launch.bind(ctypes.CDLL(str(Path(tmp) / f"{name}-{define}-{v}.so")))
            launch, _ = gl_launch.launcher(lib, name, x, dev)
            if define == "SSTTS_CLUSTER":
                label = f"full, clusters of {v}"
            else:
                label = (MASKS if name == "gl_semi" else FUSED_MASKS)[v]
            res[name][label] = time_ms(launch)
    card = card_line()
    print(json.dumps({"gl_semi_phase_ms": res["gl_semi"],
                      "gl_fused_phase_ms": res["gl_fused"], "geometry": opts.geometry,
                      "shape": [x["Bt"], x["T"], x["wp"], 2 * x["hp"]], "card": card}))


if __name__ == "__main__":
    main()
