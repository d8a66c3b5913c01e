"""The wide kind of the GRU kernels (B3 and B3' from H = 138 to the grid
kind's first width) taken apart on the card.

    python3 -m sstts_torch.tools.ablate_wide [--widths 138 256 512]

Builds variants of `sstts_torch/csrc/gru.cu`, one `nvcc` each, all started
together, into a temporary directory:

- "as built": the source as it is;
- "unroll 1", "unroll 2": the product's loop over float4 quads not
  unrolled (the first build), or unrolled by 2 (the source: by 4, so that
  the next quads' loads issue before this one's FMAs);
- "one row": every cluster takes one sequence (the rule's tile cut to one
  row whatever the clusters the card holds, so B = 32 runs in as many
  waves as the card needs: the first design's mapping, with this design's
  product);
- "no-fma": the product's FMAs left out (the gates read stale sums: the
  outputs are wrong; what is left of a step is timed);
- "no-push": the carry's (forward) and the partial dh_prev's (backward)
  stores into the cluster's ranks left out (wrong outputs; what the
  exchange through distributed shared memory costs a step is what it
  saves).

A rewrite that no longer finds what it replaces in the source stops the
script before anything is built.

At each width (B = 32, D = H, forward T = 800, backward T = 515) the
script times, with CUDA events in turns, two rounds: every cluster size C
whose tile holds at least one row (`wide_rows`), as built and unrolled;
the other variants on the cluster `kernel_config` picks; and the grid kind
at the same width (its blocks and units from `grid_shape`).  Each
configuration whose outputs should be right is first held to the plain
versions (1e-4 absolute forward, relative to the largest value backward, as
`chip_smoke.py` holds the wide kind).  Prints the clusters the card holds
at each C, ptxas's registers for the wide kernels, and one JSON line with
the card's name and power limit.
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
        raise RuntimeError(f"ablate_wide: gru.cu no longer holds {old[:60]!r}")
    return src.replace(old, new)


def _one_row(src: str) -> str:
    return _replace(src, "  int rows = (B + held - 1) / held;\n", "  int rows = 1;\n")


def _no_fma(src: str) -> str:
    src = _replace(src, "    if (prod) {\n      float acc[kRows][3] = {};",
                   "    if (prod && ws.KS < 0) {\n      float acc[kRows][3] = {};")
    return _replace(src, "    if (tid < NG) {\n      float acc[kRows][2] = {};",
                    "    if (tid < NG && ws.KS < 0) {\n      float acc[kRows][2] = {};")


def _no_push(src: str) -> str:
    src = _replace(src, "      for (int rank = 0; rank < C; ++rank) *cluster.map_shared_rank(dst, rank) = h_new;",
                   "      if (C < 0) *cluster.map_shared_rank(dst, 0) = h_new;")
    return _replace(src, "          if (b0 + r < B) *cluster.map_shared_rank(",
                    "          if (b0 + r < 0) *cluster.map_shared_rank(")


def _unroll(n: int):
    def transform(src: str) -> str:
        return _replace(src, "#pragma unroll 4\n  for (int q = q0; q < quads; q += step) {",
                        f"#pragma unroll {n}\n  for (int q = q0; q < quads; q += step) {{")
    return transform


#: name -> (transform of the source, whether its outputs are right)
VARIANTS = {
    "as built": (lambda s: s, True),
    "unroll 1": (_unroll(1), True),
    "unroll 2": (_unroll(2), True),
    "one row": (_one_row, True),
    "no-fma": (_no_fma, False),
    "no-push": (_no_push, False),
}


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    sigs = {"sstts_error_string": ([ctypes.c_int], ctypes.c_char_p), **gru.SIGNATURES}
    for fn, (argtypes, restype) in sigs.items():
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    return lib


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
        regs = re.findall(r"Compiling entry function '\w*(gru_(?:fwd|bwd)_wide\w*)'.*?"
                          r"Used (\d+) registers, .*?(\d+) bytes spill stores", log, re.S)
        print(f"ptxas {name}: {regs}", flush=True)
        libs[name] = _bind(out)
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


def _scratch(lib, kind, B, H, backward):
    if kind != gru.KIND_GRID:
        return None
    return torch.zeros(lib.sstts_gru_grid_scratch_floats(B, H, int(backward)), device="cuda")


def _forward(lib, x, kind, cluster):
    B, T, D = x["xs"].shape
    H = x["wh"].shape[0]
    gx = torch.empty(B, T, 3 * H, device="cuda")
    out = torch.empty(B, T, H, device="cuda")
    scratch = _scratch(lib, kind, B, H, False)
    rc = lib.sstts_gru_sequence(
        *(x[k].data_ptr() for k in ("xs", "wx", "wh", "b", "mask")), gx.data_ptr(),
        out.data_ptr(), None, None, None if scratch is None else scratch.data_ptr(),
        B, T, D, H, 0, kind, cluster, torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "ablate_wide forward")
    return out


def _backward(lib, x, gates, hprev, kind, cluster):
    B, T, H = x["dout"].shape
    dgx = torch.empty(B, T, 3 * H, device="cuda")
    dgh = torch.empty_like(dgx)
    scratch = _scratch(lib, kind, B, H, True)
    rc = lib.sstts_gru_sequence_backward(
        x["dout"].data_ptr(), gates.data_ptr(), hprev.data_ptr(), x["wh"].data_ptr(),
        x["mask"].data_ptr(), dgx.data_ptr(), dgh.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, T, H, 0, kind, cluster,
        torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "ablate_wide backward")
    return dgx, dgh


#: The variants timed on every cluster size, the others on the rule's only.
EVERY_CLUSTER = ("as built", "unroll 1", "unroll 2")


def _configs(libs, H, B):
    """(name, library, kind, cluster) of every timed configuration at H."""
    kind, rule_c = gru.kernel_config(H)
    out = []
    for c in range(2, gru.MAX_CLUSTER + 1):
        rows = gru.wide_rows(H, B, c, gru.wide_clusters(c, "cuda"))
        if rows:
            mark = " (the rule's)" if kind == gru.KIND_WIDE and c == rule_c else ""
            out += [(f"{name} C={c} rows={rows}{mark}", libs[name], gru.KIND_WIDE, c)
                    for name in EVERY_CLUSTER]
    if kind == gru.KIND_WIDE:
        out += [(f"{name} C={rule_c}", libs[name], gru.KIND_WIDE, rule_c)
                for name in VARIANTS if name not in EVERY_CLUSTER]
    if gru._grid_fits(H):
        gs = gru.grid_shape(H, False)
        out.append((f"grid NB={gs['NB']} U={gs['U']}", libs["as built"], gru.KIND_GRID, gs["NB"]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", nargs="+", type=int, default=[138, 256, 512])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_wide: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    res, occupancy = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build(Path(tmp))
        lib = libs["as built"]
        for c in range(2, gru.MAX_CLUSTER + 1):  # one block an SM at any H and tile
            occupancy[c] = [lib.sstts_gru_wide_active_clusters(138, c, 1, b) for b in (0, 1)]
        print(f"clusters of C the card holds at once (forward, backward; the H100 SXM's "
              f"reference table: {list(gru.WIDE_CLUSTERS)}): {occupancy}", flush=True)
        for H in args.widths:
            x = _inputs(dev, 32, 800, H, H, seed=3)
            ref, gates, hprev = gru.gru_sequence_forward_plain(x["xs"], x["wx"], x["wh"], x["b"],
                                                               x["mask"])
            xb = dict(x, dout=x["dout"][:, :515].contiguous(),
                      mask=x["mask"][:, :515].contiguous())
            gates, hprev = gates[:, :515].contiguous(), hprev[:, :515].contiguous()
            ref_b = gru.gru_sequence_backward_plain(xb["dout"], gates, hprev, x["wh"],
                                                    xb["mask"])
            res[H] = {}
            configs = _configs(libs, H, 32)
            for name, lib, kind, cluster in configs:
                right = VARIANTS.get(name.split(" C=")[0], (None, True))[1]
                fwd = float((_forward(lib, x, kind, cluster) - ref).abs().max())
                bwd = max(float((a - r).abs().max() / r.abs().max().clamp_min(1e-30))
                          for a, r in zip(_backward(lib, xb, gates, hprev, kind, cluster), ref_b))
                if right and not max(fwd, bwd) <= 1e-4:
                    raise AssertionError(f"ablate_wide H={H} {name}: forward {fwd}, "
                                         f"backward {bwd}")
                res[H][name] = {"error": [fwd, bwd], "fwd_ms": [], "bwd_ms": []}
            for _ in range(2):  # in turns
                for name, lib, kind, cluster in configs:
                    r = res[H][name]
                    r["fwd_ms"].append(time_ms(lambda: _forward(lib, x, kind, cluster), 3, 3))
                    r["bwd_ms"].append(time_ms(
                        lambda: _backward(lib, xb, gates, hprev, kind, cluster), 3, 3))
            for name, r in res[H].items():
                print(f"H = {H} {name}: forward T = 800 "
                      f"{', '.join(f'{t:.4f}' for t in r['fwd_ms'])} ms, backward T = 515 "
                      f"{', '.join(f'{t:.4f}' for t in r['bwd_ms'])} ms; error "
                      f"{r['error'][0]:.2e} / {r['error'][1]:.2e} [{card}]", flush=True)
    print(json.dumps({"card": card, "clusters_held": occupancy,
                      "ablate_wide": {str(h): v for h, v in res.items()}}))


if __name__ == "__main__":
    main()
