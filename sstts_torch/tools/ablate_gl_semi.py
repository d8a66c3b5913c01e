"""Stage breakdown of the Griffin-Lim kernels B2 and B5 on the card.

    python3 -m sstts_torch.tools.ablate_gl_semi

Builds `sstts_torch/csrc/gl_semi.cu` and `gl_fused.cu` once per stage mask
(SSTTS_ABLATE: 1 skips the A panel's loads and sums, 2 GEMM2's loads and
wgmma, 4 the epilogue's loads and stores; for B5 also 8 GEMM1's loads and
wgmma and 16 the stores of its f32 slab; one `nvcc` per mask, all started
together, into a temporary directory) and times each build at the main
path's shape, (32, 800, 1152) -> (32, 800, 2048) bf16, classic iteration,
with CUDA events.  The stages of a block overlap (and so do the blocks of a
launch), so the times do not add up: a mask says what the kernel costs
without that stage's work.  The whole kernels are also built and timed with
clusters of 1, 2 and 4 blocks (SSTTS_CLUSTER; 2 is what every other build
uses).  A build with stages skipped computes garbage;
only its time means anything.  Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from sstts_torch.dsp.gl_fused import _GlArgs, _GlFusedArgs, fused_scratch
from sstts_torch.dsp.gl_tiles import k_major
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
    7: "launch and barriers only",
}

CLUSTERS = (1, 2, 4)

FUSED_MASKS = {
    0: "full",
    8: "without GEMM1",
    16: "without the slab's stores",
    24: "tail only",
    7: "GEMM1 and slab only",
    23: "GEMM1 only",
}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_gl_semi: no CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        # (kernel, define, value) -> nvcc: a build per stage mask and per
        # cluster size
        procs = {
            (name, define, v): subprocess.Popen(
                [build.nvcc(), *build.NVCC_FLAGS, f"-D{define}={v}",
                 "-o", str(Path(tmp) / f"{name}-{define}-{v}.so"),
                 str(build.CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for name, masks in (("gl_semi", MASKS), ("gl_fused", FUSED_MASKS))
            for define, values in (("SSTTS_ABLATE", masks), ("SSTTS_CLUSTER", CLUSTERS))
            for v in values
        }
        for key, p in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc {key[0]} -D{key[1]}={key[2]} failed:\n{log}")
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
        w_fwd_t = k_major(w_fwd)
        q = torch.empty_like(mag2)
        args = _GlArgs(
            frames.data_ptr(), mag2.data_ptr(), w_fwd.data_ptr(),
            wss2d.data_ptr(), None, q.data_ptr(), None,
            Bt, T, wp, hp, plan["w_len"], hop, plan["d_max"], 0.0,
            w_fwd_t.data_ptr(),
        )
        stream = torch.cuda.current_stream().cuda_stream
        w_inv = torch.randn(2 * hp, wp, generator=g) / 32
        w_inv[:, plan["w_len"]:] = 0.0
        w_inv = w_inv.to(dev, torch.bfloat16)
        w_inv_t = k_major(w_inv)
        qin = torch.randn(Bt, T, 2 * hp, generator=g).to(dev, torch.bfloat16)
        scratch, flags = fused_scratch(dev, wp)
        fargs = _GlFusedArgs(
            qin.data_ptr(), mag2.data_ptr(), w_inv.data_ptr(), w_fwd.data_ptr(),
            wss2d.data_ptr(), scratch.data_ptr(), q.data_ptr(),
            Bt, T, wp, hp, plan["w_len"], hop, plan["d_max"], scratch.shape[0],
            w_inv_t.data_ptr(), w_fwd_t.data_ptr(), flags.data_ptr(),
        )
        res = {"gl_semi": {}, "gl_fused": {}}
        for name, define, v in procs:
            lib = ctypes.CDLL(str(Path(tmp) / f"{name}-{define}-{v}.so"))
            fn = getattr(lib, f"sstts_{name}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            a = args if name == "gl_semi" else fargs

            def launch():
                rc = fn(ctypes.byref(a), stream)
                if rc:
                    raise RuntimeError(f"{name} (-D{define}={v}): CUDA error {rc}")

            if define == "SSTTS_CLUSTER":
                label = f"full, clusters of {v}"
            else:
                label = (MASKS if name == "gl_semi" else FUSED_MASKS)[v]
            res[name][label] = time_ms(launch)
    card = card_line()
    print(json.dumps({"gl_semi_phase_ms": res["gl_semi"],
                      "gl_fused_phase_ms": res["gl_fused"],
                      "shape": [Bt, T, wp, 2 * hp], "card": card}))


if __name__ == "__main__":
    main()
