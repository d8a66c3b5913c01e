"""What one SM charges for the pieces of a recurrence kernel, on the card.

    python3 -m sstts_torch.tools.sm_microbench

Builds `sstts_torch/csrc/bench/sm_microbench.cu` with `nvcc` into a
temporary directory and runs it: shared-memory float4 loads by address
pattern, alone and before 96 multiply-adds a thread (a GRU step's inner
product at H = 128), a block barrier, and a thread-block cluster's barrier
with a store into every member's shared memory; then the stream probe:
32, 64 or 128 blocks, one a SM, each streaming decoder kernel B4's bytes a
step (3,362,816, L2-resident) through a ring of `cp.async.bulk` stages by
stage count and size, copies a stage, who polls the barrier, with and
without the consumers reading each stage, and one thread's bursts of copies
with no ring.  The GRU kernels' layouts (`csrc/gru.cu`) and B4's ring
(`csrc/stream.cuh`) follow from these readings.  Prints the program's lines
and the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

from sstts_torch.ops import build
from sstts_torch.tools import card_line


def main() -> None:
    src = build.CSRC / "bench" / "sm_microbench.cu"
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / "sm_microbench"
        subprocess.run(
            [build.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-o", str(exe), str(src)],
            check=True,
        )
        out = subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                             timeout=300).stdout
    card = card_line()
    print(out.rstrip())
    print(f"card: {card}")


if __name__ == "__main__":
    main()
