"""Kernel B2's check at the 16 kHz geometry, repeated in fresh processes.

    python3 -m sstts_torch.tools.repeat_b2 [--processes 8] [--rounds 4] [--save DIR]

Run from the repository's root: it imports `chip_smoke`.  `chip_smoke.py`
phase 2 holds B2 (`reproject_analyze`) to its plain version at each
geometry at 32 x 800 frames, on inputs made on the card from seed 3; once
(ROADMAP C.2) the 16 kHz case (n_fft 1024, window 800, hop 200: w_len 799
in 896 lanes, D = 3, the whole-panel configuration) missed.  This script
makes those inputs with `chip_smoke.gl_inputs` and holds each launch with
`chip_smoke.hold_gl`, classic and at momentum 0.99, `--rounds` times in
each of `--processes` fresh interpreters.  Every output is also compared
with the first of its process, the kernel's and the plain version's.  A
miss prints where its differing elements lie (utterances, frames, bins)
and, with `--save`, keeps the inputs and both outputs.  Prints one JSON
line with the counts and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import torch

from sstts_torch.config import Config
from sstts_torch.dsp import gl_fused as gl
from sstts_torch.dsp.gl_tiles import k_major
from sstts_torch.synthesize import exact_f32
from sstts_torch.tools import card_line


def inputs(dev) -> dict:
    """`chip_smoke.gl_geometry_times`' B2 inputs at the 16 kHz geometry."""
    import chip_smoke

    fields = next(f for tag, f, *_ in chip_smoke.GL_SIDE_GEOMETRIES if tag == "16kHz")
    ds = dataclasses.replace(Config().dataset, **fields)
    x = chip_smoke.gl_inputs(dev, 32, 800, 3, ds, torch.bfloat16, on_card=True)
    plan = x["plan"]
    return {"args": (x["frames"], x["mag2"], x["w_fwd"], x["wss2d"], plan["w_len"],
                     ds.hop_len, plan["d_max"]), "prev": x["prev"]}


def child(rounds: int, save: str | None, tag: str) -> dict:
    import chip_smoke

    dev = torch.device("cuda")
    first, misses, same = {}, [], True
    for r in range(rounds):
        x = inputs(dev)
        wt = k_major(x["args"][2])
        for m in (0.0, 0.99):
            pv = x["prev"] if m else None
            got = gl.reproject_analyze(*x["args"], pv, m, wt)
            with exact_f32(dev):
                ref = gl.reproject_analyze_plain(*x["args"], pv, m)
            torch.cuda.synchronize()
            for name, a, b in (("q", got[0], ref[0]), ("s", got[1], ref[1])):
                if a is None:
                    continue
                key = f"{'momentum' if m else 'classic'}-{name}"
                first.setdefault(key, (a.clone(), b.clone()))
                same &= torch.equal(first[key][0], a) and torch.equal(first[key][1], b)
                try:
                    chip_smoke.hold_gl("B2", f"{key}-32x800-16kHz", a, b)
                    continue
                except AssertionError:
                    pass
                d = (a.float() - b.float()).abs()
                idx = torch.nonzero(d > 2.0**-7 * float(b.float().abs().max()))
                miss = {"round": r, "case": key, "max_abs_err": float(d.max()),
                        "differing": float((a != b).float().mean()),
                        "utterances": idx[:, 0].unique().tolist()[:20],
                        "frames": idx[:, 1].unique().tolist()[:40],
                        "bins": idx[:, 2].unique().tolist()[:40]}
                misses.append(miss)
                print("MISS", json.dumps(miss), flush=True)
                if save:
                    Path(save).mkdir(parents=True, exist_ok=True)
                    torch.save({"args": [t.cpu() if torch.is_tensor(t) else t for t in x["args"]],
                                "prev": x["prev"].cpu(), "momentum": m, "kernel": a.cpu(),
                                "plain": b.cpu()}, Path(save) / f"miss-{tag}-{r}-{key}.pt")
    return {"checks": 3 * rounds, "misses": misses, "bit_equal_within_process": same}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--save")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repeat_b2: no CUDA device")
    if args.child is not None:
        print(json.dumps(child(args.rounds, args.save, args.child)))
        return
    runs = []
    for p in range(args.processes):
        cmd = [sys.executable, "-m", "sstts_torch.tools.repeat_b2", "--rounds",
               str(args.rounds), "--child", str(p)] + (["--save", args.save] if args.save else [])
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=600, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f"process {p}: {runs[-1]['checks']} checks, {len(runs[-1]['misses'])} misses, "
              f"bit-equal within the process: {runs[-1]['bit_equal_within_process']}", flush=True)
    print(json.dumps({"card": card_line(), "processes": len(runs),
                      "checks": sum(r["checks"] for r in runs),
                      "misses": sum(len(r["misses"]) for r in runs),
                      "bit_equal_within_each_process": all(r["bit_equal_within_process"]
                                                           for r in runs)}))


if __name__ == "__main__":
    main()
