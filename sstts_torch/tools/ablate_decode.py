"""Stage times of the ring kernels on the card: B4 (the ring-fed decode)
and B6 (the teacher-forced scan on the same ring and chain).

    python3 -m sstts_torch.tools.ablate_decode [--kernel decode|teacher|both]

Builds `sstts_torch/csrc/decoder.cu` (or `teacher.cu`) once for each
SSTTS_ABLATE mask, one `nvcc` per build, all started together, into a
temporary directory, and times every build with CUDA events at the main
path's shape: B4 at (B=32, T=96, S=160) bf16 with dropout, B6 at the train
step's (B=32, T=128, S=103) bf16:

- 0, the whole kernel, first held to its plain version (B4: `fin` equal, mel
  and stop within 5e-2 of the largest mel value, alignments within 5e-2;
  B6: xs within 5e-2 of its largest value, alignments within 5e-2);
- 1, the stream alone: the producer copies every chunk and the consumers
  only wait for each and release it, the design's floor;
- 2, the consumers without the stream: no copies and no waiting, so the
  products, the attention, the gates and the barriers run on whatever the
  stages hold (garbage: only the time means anything);
- 4, the whole kernel without the products' multiply-adds and their loads:
  the stream, the attention, the gates, the reductions and the barriers;
- 6, 2 and 4 together: the consumers' serial chain alone.

The stages overlap, so the times do not add up.  Prints one JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import tempfile

import torch

from sstts_torch.ops import build
from sstts_torch.ops import decoder as dec
from sstts_torch.ops import teacher as tops
from sstts_torch.tools import card_line, time_ms
from sstts_torch.tools.compare_decode_builds import compile_builds, decode_case, max_diffs

MASKS = {0: "whole", 1: "stream alone", 2: "consumers without the stream",
         4: "without the products' multiply-adds",
         6: "consumers without the stream and the multiply-adds"}


def teacher_case(dev, S: int = 103, B: int = 32, T: int = 128, seed: int = 13):
    """B6's inputs at the train step's shape from a seeded random init of
    the default `Config()`: live weights, prenet rows, memory, keys, mask
    (lengths from 40 to T)."""
    from sstts_torch.config import Config
    from sstts_torch.model.tacotron import Tacotron, init_state_dict

    cfg = Config()
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(init_state_dict(cfg.arch, cfg.dataset, seed=12))
    cell = model.decoder_cell.to(dev)
    g = torch.Generator().manual_seed(seed)
    memory = (0.5 * torch.randn(B, T, 2 * cfg.arch.encoder_gru_units, generator=g)).to(dev)
    lengths = torch.randint(min(40, T), T + 1, (B,), generator=g).to(dev)
    maskf = (torch.arange(T, device=dev)[None] < lengths[:, None]).float()
    with torch.no_grad():
        keys = cell.attention.init_keys(memory)
    pre = torch.relu(torch.randn(B, S, cfg.arch.prenet_units[-1], generator=g)).to(dev)
    return tops.teacher_weights_from_cell(cell), pre, memory, keys, maskf


def ablate_decode(dev, tmp):
    jobs = {mask: (build.CSRC / "decoder.cu", [f"SSTTS_ABLATE={mask}"]) for mask in MASKS}
    p = decode_case(dev, 160, torch.bfloat16, 1.1)
    with torch.no_grad():
        ref = dec.decode_steps_plain(p)
    scale = max(1.0, float(ref["mel"].abs().max()))
    res = {"ptxas": {}, "shape": [32, 96, 160, "bf16"]}
    libs = compile_builds(jobs, tmp)
    for mask, (lib, ptxas, _) in libs.items():
        res["ptxas"][MASKS[mask]] = ptxas
        with torch.no_grad():
            if mask == 0:
                got = dec.launch(lib, p)
                torch.cuda.synchronize()
                errs = max_diffs(got, ref)
                ok = (bool(torch.equal(got["fin"], ref["fin"]))
                      and errs["mel"] <= 5e-2 * scale and errs["stop"] <= 5e-2 * scale
                      and errs["align"] <= 5e-2)
                res["check"] = {"errors": errs, "ok": ok}
            res[MASKS[mask]] = time_ms(lambda: dec.launch(lib, p), iters=5, reps=5)
    return res


def ablate_teacher(dev, tmp):
    jobs = {mask: (build.CSRC / "teacher.cu", [f"SSTTS_ABLATE={mask}"]) for mask in MASKS}
    w, pre, memory, keys, maskf = teacher_case(dev)
    bf = torch.bfloat16
    with torch.no_grad():
        ref = tops.fused_teacher_scan_plain(w, pre, memory, keys, maskf, bf)
    scale = max(1.0, float(ref[0].abs().max()))
    res = {"ptxas": {}, "shape": [32, 128, 103, "bf16"]}
    libs = compile_builds(jobs, tmp, tops.bind)
    for mask, (lib, ptxas, _) in libs.items():
        res["ptxas"][MASKS[mask]] = ptxas
        run = lambda: tops.launch(lib, w, pre, memory, keys, maskf, bf)  # noqa: E731
        with torch.no_grad():
            if mask == 0:
                got = run()
                torch.cuda.synchronize()
                errs = {"xs": float((got[0] - ref[0]).abs().max()),
                        "align": float((got[1] - ref[1]).abs().max())}
                res["check"] = {"errors": errs,
                                "ok": errs["xs"] <= 5e-2 * scale and errs["align"] <= 5e-2}
            res[MASKS[mask]] = time_ms(run, iters=3, reps=5)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("decode", "teacher", "both"), default="decode")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_decode: no CUDA device")
    dev = torch.device("cuda")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        if args.kernel in ("decode", "both"):
            res["fused_decode"] = ablate_decode(dev, tmp)
        if args.kernel in ("teacher", "both"):
            res["fused_teacher_scan"] = ablate_teacher(dev, tmp)
    print(json.dumps({"ablate_ms": res, "card": card_line()}))


if __name__ == "__main__":
    main()
