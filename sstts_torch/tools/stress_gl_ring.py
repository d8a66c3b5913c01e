"""Kernels B2 and B5 under a stressed ring: each build's launches against
the as-built kernel's, bit for bit, on the card.

    python3 -m sstts_torch.tools.stress_gl_ring [--launches 500] [--geometry defaults]

Builds `gl_semi.cu` and `gl_fused.cu` of this tree four ways, one `nvcc`
each, all started together, into a temporary directory: as built; with
SSTTS_RING_STRESS (`csrc/gl_tail.cuh`: the producer issues the first six
stages of each bin-tile pair of GEMM2's ring as 0, 2, 4, 1, 3, 5, so that a
stage of the second consumer warpgroup lands after the first warpgroup's
next two); with SSTTS_SHARED_FULL (both warpgroups wait on one full barrier
a slot, the ring's scheme before each warpgroup had its own); and with both.
The order of the copies changes no sum, so every launch of every build must
equal the as-built kernel's first launch bit for bit.  For the classic
iteration, with momentum 0.99 and B5, at a whole-panel geometry of
`tools/gl_launch.py` (32 x 800 frames), it counts the launches of each
build that differ and the largest difference, and holds the as-built
kernel's first launch to its plain version (`chip_smoke.hold_gl`; run from
the repository's root).  Each build runs in a process of its own, so that a
build whose barriers fault (`mbar_wait` traps) costs only its own line.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from sstts_torch.dsp import gl_fused as gl
from sstts_torch.ops import build
from sstts_torch.synthesize import exact_f32
from sstts_torch.tools import card_line, gl_launch

#: build name -> its -D settings.
BUILDS = {
    "as built": (),
    "stress": ("SSTTS_RING_STRESS=1",),
    "shared barriers": ("SSTTS_SHARED_FULL=1",),
    "stress, shared barriers": ("SSTTS_RING_STRESS=1", "SSTTS_SHARED_FULL=1"),
}


def compile_all(tmp: str) -> None:
    """Every build into `tmp` as `<source>-<index in BUILDS>.so`, one `nvcc`
    a build, all started together."""
    procs = {}
    for src in ("gl_semi", "gl_fused"):
        for i, (name, defines) in enumerate(BUILDS.items()):
            out = Path(tmp) / f"{src}-{i}.so"
            procs[(src, name)] = (subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
                 "-o", str(out), str(build.CSRC / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    for key, (proc, _) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")


def plain(case: str, x: dict) -> torch.Tensor:
    """The plain version's q' for `case` on `x` (B5: `chip_smoke.b5_reference`)."""
    import chip_smoke

    plan = x["plan"]
    args = (x["frames"], x["mag2"], x["w_fwd"], x["wss2d"], plan["w_len"], x["hop"],
            plan["d_max"])
    if case == "gl_semi":
        return gl.reproject_analyze_plain(*args)[0]
    if case == "gl_semi_momentum":
        return gl.reproject_analyze_plain(*args, x["prev"], 0.99)[0]
    return chip_smoke.b5_reference(x["q"], x["mag2"], x["w_inv"], x["w_fwd"], x["wss2d"],
                                   plan["w_len"], x["hop"], plan["d_max"])


def child(tmp: str, name: str, geometry: str, launches: int) -> dict:
    """The launches of build `name` (libraries in `tmp`) against the
    as-built build's first launch, each case."""
    import chip_smoke

    dev = torch.device("cuda")
    x = gl_launch.inputs(dev, geometry, torch.bfloat16)
    res = {}
    for case in gl_launch.CASES:
        src = "gl_fused" if case == "gl_fused" else "gl_semi"
        lib = lambda n: gl_launch.bind(ctypes.CDLL(str(Path(tmp) / f"{src}-{n}.so")))  # noqa: E731
        launch, out = gl_launch.launcher(lib(list(BUILDS).index("as built")), case, x, dev)
        launch()
        ref = out.clone()
        res[case] = {}
        if name == "as built":
            with exact_f32(dev):
                res[case]["against the plain version"] = chip_smoke.hold_gl(
                    "B5" if src == "gl_fused" else "B2", f"stress-{case}", ref, plain(case, x))
        launch, out = gl_launch.launcher(lib(list(BUILDS).index(name)), case, x, dev)
        differ, largest = 0, 0.0
        for _ in range(launches):
            launch()
            if not torch.equal(out, ref):
                differ += 1
                largest = max(largest, float((out.float() - ref.float()).abs().max()))
        res[case].update(differing_launches=differ, largest_difference=largest)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=500)
    ap.add_argument("--geometry", default="defaults", choices=sorted(gl_launch.GEOMETRIES))
    ap.add_argument("--child", nargs=2, help=argparse.SUPPRESS)  # library dir, build name
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stress_gl_ring: no CUDA device")
    if args.child:
        print(json.dumps(child(*args.child, args.geometry, args.launches)))
        return
    x = gl_launch.inputs("cpu", args.geometry, torch.bfloat16, Bt=1, T=2)
    if any(gl_launch.config(case, x) != "panel" for case in gl_launch.CASES):
        raise SystemExit(f"stress_gl_ring: {args.geometry} is not a whole-panel geometry")
    res = {"card": card_line(), "geometry": args.geometry, "launches": args.launches}
    with tempfile.TemporaryDirectory() as tmp:
        compile_all(tmp)
        for name in BUILDS:
            run = subprocess.run(
                [sys.executable, "-m", "sstts_torch.tools.stress_gl_ring", "--child", tmp,
                 name, "--geometry", args.geometry, "--launches", str(args.launches)],
                capture_output=True, text=True, timeout=900)
            if run.returncode:
                res[name] = {"failed": run.returncode, "stderr": run.stderr[-600:]}
            else:
                res[name] = json.loads(run.stdout.strip().splitlines()[-1])
            print(f"{name}: {json.dumps(res[name])[:600]}", flush=True)
    print(json.dumps({"stress_gl_ring": res}))


if __name__ == "__main__":
    main()
