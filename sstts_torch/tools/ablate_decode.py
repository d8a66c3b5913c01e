"""Stage times of kernel B4 (the ring-fed decode) on the card.

    python3 -m sstts_torch.tools.ablate_decode

Builds `sstts_torch/csrc/decoder.cu` once for each SSTTS_ABLATE mask, one
`nvcc` per build, all started together, into a temporary directory, and
times every build with CUDA events at the main path's shape, (B=32, T=96,
S=160) bf16 with dropout:

- 0, the whole kernel, first held to `decode_steps_plain` (`fin` equal, mel
  and stop within 5e-2 of the largest mel value, alignments within 5e-2);
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
from sstts_torch.tools import card_line, time_ms
from sstts_torch.tools.compare_decode_builds import compile_builds, decode_case, max_diffs

MASKS = {0: "whole", 1: "stream alone", 2: "consumers without the stream",
         4: "without the products' multiply-adds",
         6: "consumers without the stream and the multiply-adds"}


def main() -> None:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_decode: no CUDA device")
    jobs = {mask: (build.CSRC / "decoder.cu", [f"SSTTS_ABLATE={mask}"]) for mask in MASKS}
    dev = torch.device("cuda")
    p = decode_case(dev, 160, torch.bfloat16, 1.1)
    with torch.no_grad():
        ref = dec.decode_steps_plain(p)
    scale = max(1.0, float(ref["mel"].abs().max()))
    res = {"ptxas": {}}
    with tempfile.TemporaryDirectory() as tmp:
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
    print(json.dumps({"ablate_decode_ms": res, "shape": [32, 96, 160, "bf16"],
                      "card": card_line()}))


if __name__ == "__main__":
    main()
