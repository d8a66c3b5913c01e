"""The grid kind of the GRU kernels (B3 and B3' from H = 544 to 5456)
taken apart on the card.

    python3 -m sstts_torch.tools.ablate_grid [--widths 560 752 1104 1420 2048 5456]

Builds variants of `sstts_torch/csrc/gru.cu`, one `nvcc` each, all started
together, into a temporary directory:

- "as built": the source as it is;
- "tiles16": K tiles of about 16 float4 quads in both directions (the
  first design; the source takes about 32 forward and 48 backward);
- "stream4", "stream-q8": past H = 1419, where a block streams part of its
  slice, a ring of 4 stages (the source: 3), or K tiles of 8 quads (the
  source: 16);
- "stream-copies", "stream-bulk": every streamed tile as 16-byte copies,
  or as one bulk copy (the source: bulk copies where the packed tiles of
  all blocks pass L2's 50 MB, from H = 2377);
- "no-fma", "no-barrier", "no-fma-no-barrier": the product's FMAs, the
  grid barrier, or both left out (their outputs are wrong; what is left of
  a step is timed);
- "no-stream": past H = 1419, the copies of the streamed tiles of each
  block's slice and their waits left out (the product reads whatever the
  ring holds: the outputs are wrong; what the stream costs a step is what
  it saves).

A rewrite that no longer finds what it replaces in the source stops the
script before anything is built.

Each variant whose outputs should be right is first held to the plain
versions at B = 33, T = 37, H = 752 (two row tiles) and at the main shape
(1e-4 absolute forward, relative to the largest value backward, as
`chip_smoke.py` holds the grid kind).  Then, at B = 32, D = 128, forward
T = 800 and backward T = 515, every variant is timed at each width with
CUDA events, in turns, two rounds.  Prints ptxas's registers for the grid
kernels and one JSON line with the card's name and power limit.
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

from sstts_torch.ops import build, gru
from sstts_torch.tools import card_line, time_ms


def _replace(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"ablate_grid: gru.cu no longer holds {old[:60]!r}")
    return src.replace(old, new)


def _no_fma(src: str) -> str:
    return _replace(src, "    if (prod) {\n      const float* stage",
                    "    if (prod && gs.KT < 0) {\n      const float* stage")


def _no_barrier(src: str) -> str:
    for what in ("new carry", "dgh of the step"):
        src = _replace(src, f"    grid.sync();  // every block's {what} is in the buffer", "")
    return src


def _no_stream(src: str) -> str:
    src = _replace(src, "      if (kStream && kt >= rt) {  // the slice's rows of a streamed tile",
                   "      if (kStream && kt >= rt && gs.KT < 0) {")
    return _replace(src, "    if (bulk && kt >= rt) {  // and the tile's slice rows",
                    "    if (bulk && kt >= rt && gs.KT < 0) {")


def _copy_rule(rule: str):
    def transform(src: str) -> str:
        return _replace(src, "    return streams() && (long long)NB * pack_floats() * 4 > kGridL2Bytes;",
                        f"    return {rule};")
    return transform


def _stream(stages: int, quads: int):
    def transform(src: str) -> str:
        src = _replace(src, "constexpr int kGridStreamStages = 3;",
                       f"constexpr int kGridStreamStages = {stages};")
        return _replace(src, "constexpr int kGridStreamQuads = 16;",
                        f"constexpr int kGridStreamQuads = {quads};")
    return transform


def _tiles16(src: str) -> str:
    return _replace(src, "const int target[3] = {bwd ? 48 : 32, 32, 16};",
                    "const int target[3] = {16, 16, 16};")


#: name -> (transform of the source, whether its outputs are right)
VARIANTS = {
    "as built": (lambda s: s, True),
    "tiles16": (_tiles16, True),
    "stream4": (_stream(4, 16), True),
    "stream-q8": (_stream(3, 8), True),
    "stream-copies": (_copy_rule("false"), True),
    "stream-bulk": (_copy_rule("streams()"), True),
    "no-fma": (_no_fma, False),
    "no-barrier": (_no_barrier, False),
    "no-fma-no-barrier": (lambda s: _no_barrier(_no_fma(s)), False),
    "no-stream": (_no_stream, False),
}


def _build(tmp: Path) -> dict:
    src = (build.CSRC / "gru.cu").read_text()
    sources = {name: transform(src) for name, (transform, _) in VARIANTS.items()}
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        path, out = tmp / f"gru{i}.cu", tmp / f"libgru{i}.so"
        path.write_text(text)
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(out), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        regs = re.findall(r"Compiling entry function '\w*(gru_(?:fwd|bwd)_grid)\w*'.*?"
                          r"Used (\d+) registers", log, re.S)
        print(f"ptxas {name}: {dict(regs)} registers", flush=True)
        lib = ctypes.CDLL(str(out))
        sigs = {"sstts_error_string": ([ctypes.c_int], ctypes.c_char_p), **gru.SIGNATURES}
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        libs[name] = lib
    return libs


def _inputs(dev, B, T, D, H, seed):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(max(T // 2, 1), T + 1, (B,), generator=g)
    lengths[0] = 0  # an all-padding row
    return {"xs": torch.randn(B, T, D, generator=g).to(dev),
            "wx": (torch.randn(D, 3 * H, generator=g) / D**0.5).to(dev),
            "wh": (torch.randn(H, 3 * H, generator=g) / H**0.5).to(dev),
            "b": (0.1 * torch.randn(3 * H, generator=g)).to(dev),
            "mask": (torch.arange(T)[None] < lengths[:, None]).float().to(dev),
            "dout": torch.randn(B, T, H, generator=g).to(dev)}


def _forward(lib, x):
    B, T, D = x["xs"].shape
    H = x["wh"].shape[0]
    dev = x["xs"].device
    gx = torch.empty(B, T, 3 * H, device=dev)
    out = torch.empty(B, T, H, device=dev)
    scratch = torch.zeros(lib.sstts_gru_grid_scratch_floats(B, H, 0), device=dev)
    rc = lib.sstts_gru_sequence(
        *(x[k].data_ptr() for k in ("xs", "wx", "wh", "b", "mask")), gx.data_ptr(),
        out.data_ptr(), None, None, scratch.data_ptr(), B, T, D, H, 0, gru.KIND_GRID,
        lib.sstts_gru_grid_blocks(H), torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "ablate_grid forward")
    return out


def _backward(lib, x, gates, hprev):
    B, T, H = x["dout"].shape
    dev = x["dout"].device
    dgx = torch.empty(B, T, 3 * H, device=dev)
    dgh = torch.empty_like(dgx)
    scratch = torch.zeros(lib.sstts_gru_grid_scratch_floats(B, H, 1), device=dev)
    rc = lib.sstts_gru_sequence_backward(
        x["dout"].data_ptr(), gates.data_ptr(), hprev.data_ptr(), x["wh"].data_ptr(),
        x["mask"].data_ptr(), dgx.data_ptr(), dgh.data_ptr(), scratch.data_ptr(), B, T, H, 0,
        gru.KIND_GRID, lib.sstts_gru_grid_blocks(H), torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "ablate_grid backward")
    return dgx, dgh


def _held(libs, x, T_bwd):
    """Each right variant's outputs against the plain versions."""
    ref, gates, hprev = gru.gru_sequence_forward_plain(x["xs"], x["wx"], x["wh"], x["b"],
                                                       x["mask"])
    xb = dict(x, dout=x["dout"][:, :T_bwd].contiguous(), mask=x["mask"][:, :T_bwd].contiguous())
    gates, hprev = gates[:, :T_bwd].contiguous(), hprev[:, :T_bwd].contiguous()
    ref_b = gru.gru_sequence_backward_plain(xb["dout"], gates, hprev, x["wh"], xb["mask"])
    errs = {}
    for name, lib in libs.items():
        if not VARIANTS[name][1]:
            continue
        fwd = float((_forward(lib, x) - ref).abs().max())
        bwd = max(float((a - r).abs().max() / r.abs().max().clamp_min(1e-30))
                  for a, r in zip(_backward(lib, xb, gates, hprev), ref_b))
        if not max(fwd, bwd) <= 1e-4:
            raise AssertionError(f"ablate_grid {name}: forward {fwd}, backward {bwd}")
        errs[name] = (fwd, bwd)
    return errs, xb, gates, hprev


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", nargs="+", type=int,
                    default=[560, 752, 1104, 1420, 2048, 5456])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_grid: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(Path(tmp))
        errs, _, _, _ = _held(libs, _inputs(dev, 33, 37, 128, 752, seed=5), 37)
        print(f"B = 33, T = 37, H = 752, against the plain versions: {errs}", flush=True)
        res = {}
        for H in args.widths:
            x = _inputs(dev, 32, 800, 128, H, seed=3)
            errs, xb, gates, hprev = _held(libs, x, 515)
            for name, lib in libs.items():
                fits = max(lib.sstts_gru_grid_smem_bytes(H, b) for b in (0, 1)) <= build.MAX_SMEM
                res.setdefault(H, {})[name] = {"error": errs.get(name), "fwd_ms": [],
                                               "bwd_ms": []} if fits else None
            for _ in range(2):  # in turns
                for name, lib in libs.items():
                    r = res[H][name]
                    if r is None:
                        continue
                    r["fwd_ms"].append(time_ms(lambda: _forward(lib, x), 3, 3))
                    r["bwd_ms"].append(time_ms(lambda: _backward(lib, xb, gates, hprev), 3, 3))
            for name, r in res[H].items():
                if r is None:
                    print(f"H = {H} {name}: its block does not fit", flush=True)
                    continue
                print(f"H = {H} {name}: forward T = 800 "
                      f"{', '.join(f'{t:.4f}' for t in r['fwd_ms'])} ms, backward T = 515 "
                      f"{', '.join(f'{t:.4f}' for t in r['bwd_ms'])} ms; error {r['error']} "
                      f"[{card}]", flush=True)
    print(json.dumps({"card": card, "ablate_grid": {str(h): v for h, v in res.items()}}))


if __name__ == "__main__":
    main()
