"""What the Griffin-Lim kernel tools share: the geometries, seeded inputs,
and a launch of kernel B2 or B5 from any build of `gl_semi.cu` /
`gl_fused.cu` (this tree's or another's), in the tile configuration
`gl_tiles.config` picks.

Used by `compare_gl_builds.py` and `ablate_gl_semi.py`.  A build that lacks
the configuration a geometry needs (a tree from before the wide one) gets
no launch: `launcher` returns None.
"""

from __future__ import annotations

import ctypes

import torch

from sstts_torch.dsp import gl_tiles
from sstts_torch.dsp.gl_fused import (
    _FUSED_SIGNATURES, _SIGNATURES, _GlArgs, _GlFusedArgs, fused_scratch, wide_scratch,
)
from sstts_torch.dsp.reproject import band_plan, padded_wss2d

#: name -> (n_fft, hop, window) of the dataset settings the kernels take:
#: the defaults (22.05 kHz, 50 / 12.5 ms), 16 kHz at n_fft 1024, 24 kHz at
#: 50 / 12.5 ms, 22.05 kHz at hops of 10, 5 and 3 ms, 44.1 kHz at n_fft
#: 2048 with a 2048-sample window and a 512-sample hop, 48 kHz and 44.1 kHz
#: at n_fft 4096 and 50 / 12.5 ms, and 22.05 kHz at hops of 2.86 and 1.55 ms
#: (D = 17 and 32).
GEOMETRIES = {
    "defaults": (2048, 275, 1102),
    "16kHz": (1024, 200, 800),
    "24kHz": (2048, 300, 1200),
    "hop10ms": (2048, 220, 1102),
    "hop5ms": (2048, 110, 1102),
    "hop3ms": (2048, 66, 1102),
    "44kHz": (2048, 512, 2048),
    "48kHz": (4096, 600, 2400),
    "44kHz4096": (4096, 551, 2205),
    "hop2.86ms": (2048, 63, 1102),
    "hop1.55ms": (2048, 34, 1102),
}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CASES = ("gl_semi", "gl_semi_momentum", "gl_fused")


def inputs(dev, geometry: str, dtype: torch.dtype, Bt: int = 32, T: int = 800,
           seed: int = 5) -> dict:
    """Seeded inputs of B2 and B5 at a geometry of `GEOMETRIES` in the loop
    dtype, with the loop's lanes: wp the support rounded up to 128, hp the
    bins (n_fft / 2 in bf16, whose loop packs Nyquist into DC; n_fft / 2 + 1
    in f32) rounded up to 128."""
    n_fft, hop, win = GEOMETRIES[geometry]
    plan = band_plan(n_fft, hop, win, T, (T - 1) * hop)
    w_len = plan["w_len"]
    wp = gl_tiles.round_up(w_len, 128)
    hp = gl_tiles.round_up(n_fft // 2 + (dtype == torch.float32), 128)
    g = torch.Generator().manual_seed(seed)
    frames = torch.randn(Bt, T, wp, generator=g)
    frames[..., w_len:] = 0.0
    w_inv = torch.randn(2 * hp, wp, generator=g) / 32
    w_inv[:, w_len:] = 0.0
    x = {
        "frames": frames, "q": torch.randn(Bt, T, 2 * hp, generator=g),
        "mag2": torch.rand(Bt, T, 2 * hp, generator=g), "w_inv": w_inv,
        "w_fwd": torch.randn(wp, 2 * hp, generator=g) / 32,
        "prev": torch.randn(Bt, T, 2 * hp, generator=g),
    }
    x = {k: v.to(dev, dtype) for k, v in x.items()}
    x.update(wss2d=padded_wss2d(plan, wp, dev), w_fwd_t=gl_tiles.k_major(x["w_fwd"]),
             w_inv_t=gl_tiles.k_major(x["w_inv"]), plan=plan, hop=hop, wp=wp, hp=hp,
             Bt=Bt, T=T, dtype=dtype)
    return x


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C functions a build of either source has."""
    for fn, (argtypes, restype) in {**_SIGNATURES, **_FUSED_SIGNATURES}.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    if hasattr(lib, "sstts_gl_fused_scratch_rows"):  # the first port's B5
        lib.sstts_gl_fused_scratch_rows.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.sstts_gl_fused_scratch_rows.restype = ctypes.c_int
    return lib


def config(case: str, x: dict) -> str:
    """The tile configuration this tree's wrappers run for `case` at `x`."""
    kernel = "gl_fused" if case == "gl_fused" else "gl_semi"
    return gl_tiles.config(kernel, x["wp"], x["hp"], x["plan"]["w_len"],
                           x["plan"]["d_max"], case == "gl_fused", x["dtype"])[0]


def launcher(lib: ctypes.CDLL, case: str, x: dict, dev):
    """(launch, output) of `case` at inputs `x` from the bound build `lib`,
    in `config(case, x)`; None if the build lacks that configuration or its
    own count refuses the geometry (a tree from before the geometry was
    taken).  The launch raises on a CUDA error."""
    cfg = config(case, x)
    kernel = "gl_fused" if case == "gl_fused" else "gl_semi"
    fn_name = f"sstts_{kernel}{'_wide' if cfg == 'wide' else ''}"
    if not hasattr(lib, fn_name):
        return None
    fn = getattr(lib, fn_name)
    plan, hp, wp = x["plan"], x["hp"], x["wp"]
    w_len, d_max = plan["w_len"], plan["d_max"]
    if cfg == "wide" and getattr(lib, f"{fn_name}_smem_bytes")(w_len, d_max) < 0:
        return None
    f32 = int(x["dtype"] == torch.float32)
    out = torch.empty_like(x["mag2"])
    keep = [out]
    if kernel == "gl_semi":
        slabs, n_slabs = (wide_scratch(lib, kernel, dev, wp, out.element_size(), d_max)
                          if cfg == "wide" else (None, 0))
        s_out = torch.empty_like(out) if case == "gl_semi_momentum" else None
        prev = x["prev"] if s_out is not None else None
        keep += [s_out]
        a = _GlArgs(
            x["frames"].data_ptr(), x["mag2"].data_ptr(), x["w_fwd"].data_ptr(),
            x["wss2d"].data_ptr(), None if prev is None else prev.data_ptr(),
            out.data_ptr(), None if s_out is None else s_out.data_ptr(),
            x["Bt"], x["T"], wp, hp, w_len, x["hop"], d_max,
            0.99 if prev is not None else 0.0, x["w_fwd_t"].data_ptr(),
            None if slabs is None else slabs.data_ptr(), n_slabs, f32,
        )
    else:
        flags = None
        if cfg == "wide":
            scratch, n_slabs = wide_scratch(lib, kernel, dev, wp, out.element_size(), d_max)
        elif hasattr(lib, "sstts_gl_fused_scratch_rows"):  # a slab per block
            rows = lib.sstts_gl_fused_scratch_rows(x["T"], d_max)
            scratch = torch.empty(x["Bt"], rows, wp, dtype=torch.float32, device=dev)
            n_slabs = x["Bt"]
        else:  # a slab per SM, taken and given back by the blocks
            scratch, flags = fused_scratch(dev, wp)
            n_slabs = scratch.shape[0]
        keep += [scratch]
        a = _GlFusedArgs(
            x["q"].data_ptr(), x["mag2"].data_ptr(), x["w_inv"].data_ptr(),
            x["w_fwd"].data_ptr(), x["wss2d"].data_ptr(), scratch.data_ptr(),
            out.data_ptr(), x["Bt"], x["T"], wp, hp, w_len, x["hop"], d_max, n_slabs,
            x["w_inv_t"].data_ptr(), x["w_fwd_t"].data_ptr(),
            None if flags is None else flags.data_ptr(), f32,
        )
    stream = torch.cuda.current_stream().cuda_stream

    def launch(a=a, keep=keep):
        rc = fn(ctypes.byref(a), stream)
        if rc:
            raise RuntimeError(f"{fn_name} ({case}): CUDA error {rc}")

    return launch, out
