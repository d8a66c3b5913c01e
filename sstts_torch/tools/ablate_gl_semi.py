"""Phase breakdown of the Griffin-Lim kernel (B2) on the card.

    python3 -m sstts_torch.tools.ablate_gl_semi

Builds `sstts_torch/csrc/gl_semi.cu` once per phase mask (SSTTS_ABLATE:
1 drops the A-panel build, 2 the GEMM, 4 the renorm epilogue; one `nvcc`
per mask, all started together, into a temporary directory) and times each
build at the main path's shape, (32, 800, 1152) -> (32, 800, 2048) bf16,
classic iteration, with CUDA events.  A build with phases dropped computes
garbage; only its time means anything.  Prints one JSON line with the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from sstts_torch.dsp.gl_fused import _GlArgs
from sstts_torch.dsp.reproject import band_plan, padded_wss2d
from sstts_torch.ops import build
from sstts_torch.tools import card_line, time_ms

MASKS = {
    0: "full",
    1: "without A panel",
    2: "without GEMM",
    4: "without epilogue",
    6: "A panel only",
    5: "GEMM only",
    3: "epilogue only",
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gl_semi: no CUDA device")
    src = build.CSRC / "gl_semi.cu"
    with tempfile.TemporaryDirectory() as tmp:
        procs = {
            m: subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, f"-DSSTTS_ABLATE={m}",
                 "-o", str(Path(tmp) / f"m{m}.so"), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for m in MASKS
        }
        for m, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc -DSSTTS_ABLATE={m} failed:\n{log}")
        dev = torch.device("cuda")
        Bt, T, wp, hp = 32, 800, 1152, 1024
        n_fft, hop, win = 2048, 275, 1102
        plan = band_plan(n_fft, hop, win, T, (T - 1) * hop)
        g = torch.Generator().manual_seed(5)
        frames = torch.randn(Bt, T, wp, generator=g)
        frames[..., plan["w_len"]:] = 0.0
        frames = frames.to(dev, torch.bfloat16)
        mag2 = torch.rand(Bt, T, 2 * hp, generator=g).to(dev, torch.bfloat16)
        w_fwd = (torch.randn(wp, 2 * hp, generator=g) / 32).to(dev, torch.bfloat16)
        wss2d = padded_wss2d(plan, wp, dev)
        q = torch.empty_like(mag2)
        args = _GlArgs(
            frames.data_ptr(), mag2.data_ptr(), w_fwd.data_ptr(),
            wss2d.data_ptr(), None, q.data_ptr(), None,
            Bt, T, wp, hp, plan["w_len"], hop, plan["d_max"], 0.0,
        )
        stream = torch.cuda.current_stream().cuda_stream
        res = {}
        for m, name in MASKS.items():
            lib = ctypes.CDLL(str(Path(tmp) / f"m{m}.so"))
            lib.sstts_gl_semi.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.sstts_gl_semi.restype = ctypes.c_int

            def launch():
                rc = lib.sstts_gl_semi(ctypes.byref(args), stream)
                if rc:
                    raise RuntimeError(f"gl_semi (mask {m}): CUDA error {rc}")

            res[name] = time_ms(launch)
    card = card_line()
    print(json.dumps({"gl_semi_phase_ms": res, "shape": [Bt, T, wp, 2 * hp],
                      "card": card}))


if __name__ == "__main__":
    main()
