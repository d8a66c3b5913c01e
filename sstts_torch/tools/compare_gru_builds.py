"""Kernels B3 and B3' built from two source trees, on one card, in one run.

    python3 -m sstts_torch.tools.compare_gru_builds --base OTHER/sstts_torch/csrc \
        [--widths 138 256 512 560 752 1104]

Builds `gru.cu` from `--base` (the `csrc` directory of another checkout,
for example a parent commit unpacked with `git archive`) and from this
checkout, both `nvcc` runs started together, into a temporary directory.
At each width both builds get the same inputs (B = 32; forward T = 800,
backward T = 515 from the plain forward's saved gates; D = H for the wide
kind, the model's 128 past it; a ragged mask whose row 0 is all padding)
and the kind and cluster size (or grid blocks) each tree's rule picks:
this tree's `kernel_config`, and for a base whose wide kind runs one
sequence a cluster (its library has no `sstts_gru_wide_rows`) that kind's
rule up to H = 543, the smallest cluster whose block fits by the base
library's own counts.  The script reports whether the two builds' outputs
(out, gates, hprev; dgx, dgh) are bit-equal, the largest difference where
they are not, each build's largest difference from the plain versions
(absolute forward, relative to the largest value backward), and their
times from CUDA events (one untimed round, then the order base, new, new,
base, three times over).  A base whose library has no
`sstts_gru_grid_resident` takes one more argument before the stream (the
rows of each slice in shared memory: H at these widths).  Prints one JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from sstts_torch.ops import build, gru
from sstts_torch.tools import card_line, time_ms

_P, _I = ctypes.c_void_p, ctypes.c_int


def _build(csrc: Path, out: Path) -> subprocess.Popen:
    return subprocess.Popen(
        [build.nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out), str(csrc / "gru.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _bind(path: Path):
    """The library and whether its entry points take the rows argument."""
    lib = ctypes.CDLL(str(path))
    rows = not hasattr(lib, "sstts_gru_grid_resident")
    if not hasattr(lib, "sstts_gru_wide_rows"):  # one sequence a cluster
        for fn in ("sstts_gru_wide_smem_bytes", "sstts_gru_wide_bwd_smem_bytes"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = [_I] * 2, _I
    extra = [_I] if rows else []
    lib.sstts_gru_sequence.argtypes = [_P] * 10 + [_I] * 7 + extra + [_P]
    lib.sstts_gru_sequence_backward.argtypes = [_P] * 8 + [_I] * 6 + extra + [_P]
    for fn in ("sstts_gru_sequence", "sstts_gru_sequence_backward"):
        getattr(lib, fn).restype = _I
    lib.sstts_gru_grid_scratch_floats.argtypes = [_I] * 3
    lib.sstts_gru_grid_scratch_floats.restype = ctypes.c_longlong
    lib.sstts_error_string.argtypes, lib.sstts_error_string.restype = [_I], ctypes.c_char_p
    return lib, rows


def _config(lib, H: int):
    """(kind, cluster or blocks) that the library's own tree picks at H."""
    if hasattr(lib, "sstts_gru_wide_rows") or not 137 < H <= 543:
        return gru.kernel_config(H)
    for c in range(2, gru.MAX_CLUSTER + 1):
        if max(lib.sstts_gru_wide_smem_bytes(H, c),
               lib.sstts_gru_wide_bwd_smem_bytes(H, c)) <= build.MAX_SMEM:
            return gru.KIND_WIDE, c
    raise RuntimeError(f"compare_gru_builds: no cluster of the base holds H = {H}")


def _inputs(dev, H: int, seed: int = 3) -> dict:
    kind = gru.kernel_config(H)[0]
    B, T, D = 32, 800, H if kind == gru.KIND_WIDE else 128
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(T // 2, T + 1, (B,), generator=g)
    lengths[0] = 0
    x = {"xs": torch.randn(B, T, D, generator=g), "wx": torch.randn(D, 3 * H, generator=g) / D**0.5,
         "wh": torch.randn(H, 3 * H, generator=g) / H**0.5,
         "b": 0.1 * torch.randn(3 * H, generator=g),
         "mask": (torch.arange(T)[None] < lengths[:, None]).float(),
         "dout": torch.randn(B, 515, H, generator=g)}
    x = {k: v.to(dev).contiguous() for k, v in x.items()}
    x["ref"] = gru.gru_sequence_forward_plain(x["xs"], x["wx"], x["wh"], x["b"], x["mask"])
    _, gates, hprev = x["ref"]
    x["gates_b"], x["hprev_b"] = gates[:, :515].contiguous(), hprev[:, :515].contiguous()
    x["mask_b"] = x["mask"][:, :515].contiguous()
    x["ref_b"] = gru.gru_sequence_backward_plain(x["dout"], x["gates_b"], x["hprev_b"], x["wh"],
                                                 x["mask_b"])
    return x


def _forward(lib, rows: bool, x: dict):
    B, T, D = x["xs"].shape
    H = x["wh"].shape[0]
    kind, cluster = _config(lib, H)
    dev = x["xs"].device
    gx = torch.empty(B, T, 3 * H, device=dev)
    out = torch.empty(B, T, H, device=dev)
    gates = torch.empty(B, T, 4 * H, device=dev)
    hprev = torch.empty(B, T, H, device=dev)
    scratch = (torch.zeros(lib.sstts_gru_grid_scratch_floats(B, H, 0), device=dev)
               if kind == gru.KIND_GRID else None)
    rc = lib.sstts_gru_sequence(
        *(x[k].data_ptr() for k in ("xs", "wx", "wh", "b", "mask")), gx.data_ptr(),
        out.data_ptr(), gates.data_ptr(), hprev.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, T, D, H, 0, kind, cluster,
        *([H] if rows else []), torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "compare_gru_builds forward")
    return out, gates, hprev


def _backward(lib, rows: bool, x: dict):
    B, T, H = x["dout"].shape
    kind, cluster = _config(lib, H)
    dev = x["dout"].device
    dgx = torch.empty(B, T, 3 * H, device=dev)
    dgh = torch.empty_like(dgx)
    scratch = (torch.zeros(lib.sstts_gru_grid_scratch_floats(B, H, 1), device=dev)
               if kind == gru.KIND_GRID else None)
    rc = lib.sstts_gru_sequence_backward(
        x["dout"].data_ptr(), x["gates_b"].data_ptr(), x["hprev_b"].data_ptr(),
        x["wh"].data_ptr(), x["mask_b"].data_ptr(), dgx.data_ptr(), dgh.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, T, H, 0, kind, cluster,
        *([H] if rows else []), torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "compare_gru_builds backward")
    return dgx, dgh


def _equal(a, b) -> dict:
    """Bit-equal, or the largest difference and the share that differs."""
    same = all(torch.equal(p, q) for p, q in zip(a, b))
    if same:
        return {"bit_equal": True}
    return {"bit_equal": False,
            "max_abs_diff": max(float((p - q).abs().max()) for p, q in zip(a, b)),
            "share_differing": sum(int((p != q).sum()) for p, q in zip(a, b))
            / sum(p.numel() for p in a)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path, help="the other tree's csrc directory")
    ap.add_argument("--widths", nargs="+", type=int, default=[138, 256, 512, 560, 752, 1104])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_gru_builds: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"base": Path(tmp) / "libgru_base.so", "new": Path(tmp) / "libgru_new.so"}
        procs = {"base": _build(args.base.resolve(), paths["base"]),
                 "new": _build(build.CSRC, paths["new"])}
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc {name} failed:\n{log}")
        libs = {name: _bind(path) for name, path in paths.items()}
        for H in args.widths:
            x = _inputs(dev, H)
            outs = {n: (_forward(lib, rows, x), _backward(lib, rows, x))
                    for n, (lib, rows) in libs.items()}
            torch.cuda.synchronize()
            r = {"kind": {n: _config(lib, H) for n, (lib, _) in libs.items()},
                 "forward": _equal(outs["base"][0], outs["new"][0]),
                 "backward": _equal(outs["base"][1], outs["new"][1]),
                 "plain_error": {n: [max(float((a - b).abs().max())
                                         for a, b in zip(o[0], x["ref"])),
                                     max(float((a - b).abs().max() / b.abs().max())
                                         for a, b in zip(o[1], x["ref_b"]))]
                                 for n, o in outs.items()},
                 "fwd_ms": {"base": [], "new": []}, "bwd_ms": {"base": [], "new": []}}
            for _ in range(3):
                for n in ("base", "new", "new", "base"):
                    lib, rows = libs[n]
                    r["fwd_ms"][n].append(time_ms(lambda: _forward(lib, rows, x), 3, 3))
                    r["bwd_ms"][n].append(time_ms(lambda: _backward(lib, rows, x), 3, 3))
            for key in ("fwd_ms", "bwd_ms"):
                r[key] = {n: statistics.median(v) for n, v in r[key].items()}
            print(f"H = {H} {r['kind']}: forward {r['forward']} base {r['fwd_ms']['base']:.4f} "
                  f"new {r['fwd_ms']['new']:.4f} ms; backward {r['backward']} base "
                  f"{r['bwd_ms']['base']:.4f} new {r['bwd_ms']['new']:.4f} ms; from the plain "
                  f"versions (forward, backward) {r['plain_error']} [{card}]", flush=True)
            res[H] = r
    print(json.dumps({"card": card, "compare_gru_builds": {str(h): v for h, v in res.items()}}))


if __name__ == "__main__":
    main()
