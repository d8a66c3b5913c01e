"""Stage times of kernel B1 (the banded reprojection with its mirror runs)
on the card.

    python3 -m sstts_torch.tools.ablate_reproject [--out FILE]

Builds `sstts_torch/csrc/reproject.cu` as it is and once for each
SSTTS_ABLATE mask, one `nvcc` per build, all started together, into a
temporary directory, and times each with CUDA events at the split
iteration's shape, (32, 800) frames at wp = 1152 in bf16 and f32.  The
build as it is is first held to `reproject_frames_plain` bit for bit.  The
masks: 1 the stream alone (the consumers only wait for and release each
stage), 2 without the stream (no copies, no waiting: the arithmetic on
whatever the ring holds), 4 without the terms d != 0 (the stream, the d = 0
term, the envelope and the stores).

Ablated builds compute garbage; the stages overlap, so the times do not add
up.  Prints one JSON line with the times, ptxas's registers and spills, the
card's name and power limit; `--out` writes the same object to a file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from sstts_torch.dsp import reproject as rp
from sstts_torch.ops import build
from sstts_torch.tools import card_line, time_ms

MASKS = {0: "whole kernel", 1: "stream alone", 2: "without the stream",
         4: "without the terms d != 0"}


def compile_all(jobs, tmp):
    """{key: [-D settings]} -> {key: (bound CDLL, registers per kernel)}."""
    procs = {}
    for key, defines in jobs.items():
        out = Path(tmp) / f"reproject-{abs(hash(key))}.so"
        procs[key] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(out),
             str(build.CSRC / "reproject.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {key} failed:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
        libs[key] = (rp.bind(ctypes.CDLL(str(out))), {"registers": regs, "spill_stores": spills})
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="file for every reading (JSON)")
    args_ns = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_reproject: no CUDA device")
    dev = torch.device("cuda")
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
    args = (wss2d, plan["w_len"], ds.hop_len, plan["d_max"], plan["runs"])
    res = {"shape": [32, T, wp], "ptxas": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = compile_all({m: [f"SSTTS_ABLATE={m}"] for m in MASKS}, tmp)
        for dt in (torch.bfloat16, torch.float32):
            f3 = frames.to(dev, dt)
            out = {}
            for m, (lib, ptxas) in libs.items():
                res["ptxas"][MASKS[m]] = ptxas
                if m == 0:
                    got = rp.launch(lib, f3, *args)
                    out["bit_equal"] = bool(torch.equal(
                        got, rp.reproject_frames_plain(f3, *geom, wss2d)))
                out[MASKS[m]] = time_ms(lambda: rp.launch(lib, f3, *args))
            res[str(dt).split(".")[-1]] = out
    if args_ns.out:
        Path(args_ns.out).write_text(json.dumps(res))
    print(json.dumps({"ablate_reproject": res, "card": card_line()}))


if __name__ == "__main__":
    main()
