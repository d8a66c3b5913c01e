"""Fused Griffin-Lim iterations: the ports of kernels B2 and B5.

B2, the semi-fused iteration tail, is the port of
`sstts/dsp/gl_fused.py:fused_reproject_analyze` (227-488).  One call
takes the synthesis frames F = q @ w_inv (computed outside, as in JAX) and
returns the next spectrum:

    q' = renorm( bf16(wss2d * shift_add(F)) @ w_fwd )

with the renorm q' = s * rsqrt(re^2 + im^2 + 1e-24) * mag on the flat
(..., n_frames, 2*hp) layout (real lanes [0, hp), imaginary [hp, 2*hp)).
With momentum the renorm takes s + m*(s - prev) and the call also returns s.

`reproject_analyze` is the kernel's own function, without the edge rows:
a CPU tensor runs `reproject_analyze_plain`, a CUDA tensor launches
`sstts_torch/csrc/gl_semi.cu` or raises.  `fused_reproject_analyze` adds the
exact repair of the reflect-pad edge rows in plain torch, as the JAX package
repairs them in XLA after its kernel.

B5, the whole iteration, is the port of `fused_gl_iteration` (84-188,
491-645): GEMM1 q @ w_inv moves inside the kernel and its frames stay f32
through the shift-add.  `gl_iteration` is the kernel's own function (a CPU
tensor runs `gl_iteration_plain`, a CUDA tensor launches
`sstts_torch/csrc/gl_fused.cu` or raises); `fused_gl_iteration` adds the
edge repair, rebuilding those rows from q (`_edge_frames`).

Both kernels take the loop dtype of their inputs, bf16 or f32, and come in
two tile configurations that `gl_tiles.config` picks from the geometry and
the dtype before anything is launched: the whole panel (bf16, the default
geometry and the 16 kHz one) and the wide one (`csrc/gl_wide.cuh`:
everything else inside n_fft <= 2048 and D <= 16; the f32 loop as three tf32
products).  Beyond both they raise NotImplementedError.  They read their
weight matrices K-major (`gl_tiles.k_major`: the transposed, contiguous
copy); the Griffin-Lim loop makes those copies once per call and passes
them (`w_fwd_t`, `w_inv_t`), a lone call makes them itself.  The whole
panel's B5 passes its f32 frames through a scratch of one slab per SM
(`fused_scratch`); the wide configuration gives each resident block a slab
for its panel (and B5's frames) (`wide_scratch`); both are kept between
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from sstts_torch.dsp import gl_tiles
from sstts_torch.dsp.reproject import (
    apply_mirror_runs,
    band_plan,
    padded_wss2d,
    shift_add_rows,
)
from sstts_torch.ops import build, require_no_grad


class _GlArgs(ctypes.Structure):
    """Mirror of `GlArgs` in csrc/gl_semi.cu (same field order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("frames", "mag2", "w_fwd", "wss2d", "prev", "q_out", "s_out")
    ] + [
        (name, ctypes.c_int)
        for name in ("Bt", "T", "wp", "hp", "w_len", "hop", "d_max")
    ] + [("momentum", ctypes.c_float), ("w_fwd_t", ctypes.c_void_p),
         ("slab", ctypes.c_void_p), ("n_slabs", ctypes.c_int), ("f32", ctypes.c_int)]


_SIGNATURES = {
    "sstts_gl_semi": ([ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "sstts_gl_semi_smem_bytes": ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "sstts_gl_semi_wide": ([ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "sstts_gl_semi_wide_smem_bytes": ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "sstts_gl_semi_wide_blocks_per_sm": ([ctypes.c_int], ctypes.c_int),
}


def renorm(
    s32: torch.Tensor, mag2: torch.Tensor, hp: int, dtype: torch.dtype
) -> torch.Tensor:
    """q = s * rsqrt(|s|^2 + 1e-24) * mag, per bin over the (re, im) lanes."""
    sr = s32[..., :hp]
    si = s32[..., hp:]
    inv = torch.rsqrt(sr * sr + si * si + 1e-24)
    return (s32 * torch.cat([inv, inv], dim=-1) * mag2.float()).to(dtype)


def reproject_analyze_plain(
    frames: torch.Tensor,
    mag2: torch.Tensor,
    w_fwd: torch.Tensor,
    wss2d: torch.Tensor,
    w_len: int,
    hop: int,
    d_max: int,
    prev: Optional[torch.Tensor] = None,
    momentum: float = 0.0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function in plain torch, without the edge repair.

    frames (Bt, T, wp), mag2/prev (Bt, T, 2*hp), w_fwd (wp, 2*hp) in the
    loop dtype; wss2d (T, wp) f32.  Returns (q', s or None) in the loop
    dtype.  The product is exact f32 over operands rounded to the loop
    dtype, i.e. the tensor-core product with f32 accumulation.
    """
    dtype = frames.dtype
    n_frames = frames.shape[-2]
    hp = mag2.shape[-1] // 2
    acc = shift_add_rows(frames, w_len, hop, d_max, 0, n_frames)
    fr = (acc * wss2d).to(dtype)
    s32 = fr.float() @ w_fwd.float()
    if prev is None or momentum <= 0.0:
        return renorm(s32, mag2, hp, dtype), None
    m32 = float(np.float32(momentum))
    ex = s32 + m32 * (s32 - prev.float())
    return renorm(ex, mag2, hp, dtype), s32.to(dtype)


_checked = {}


def _config(lib, kernel, wp, hp, w_len, d_max, fused, dtype) -> str:
    """The tile configuration of a launch ("panel" or "wide",
    `gl_tiles.config`), which refuses what neither takes; its shared memory
    held to the library's own count once per shape."""
    key = (kernel, wp, hp, w_len, d_max, dtype)
    if key not in _checked:
        name, smem = gl_tiles.config(kernel, wp, hp, w_len, d_max, fused, dtype)
        counted = getattr(lib, f"sstts_{kernel}{'_wide' if name == 'wide' else ''}_smem_bytes")
        if counted(w_len, d_max) != smem:
            raise RuntimeError(f"{kernel}: dsp/gl_tiles.py and the CUDA source disagree")
        _checked[key] = name
    return _checked[key]


def _loop_dtype(kernel, *tensors) -> torch.dtype:
    """The one dtype of the kernel's inputs: bf16 or f32."""
    dtypes = {t.dtype for t in tensors if t is not None}
    if len(dtypes) != 1 or not dtypes <= {torch.bfloat16, torch.float32}:
        raise NotImplementedError(
            f"{kernel} CUDA kernel takes one loop dtype, bf16 or f32: {sorted(map(str, dtypes))}"
        )
    return dtypes.pop()


#: (kernel, device index, stream, wp, elem bytes) -> the wide configuration's
#: slabs: one per block the card holds at once (a persistent grid, block b
#: on slab b), kept between launches.  Launches on one stream run one after
#: another and share them; two streams could run at once, so each has its
#: own.
_wide_slabs = {}


def wide_scratch(lib, kernel: str, device: torch.device, wp: int, elem_bytes: int):
    """(slabs, count) of `device` and its current stream for the wide
    configuration of `kernel` ("gl_semi" or "gl_fused") at rows of `wp`
    lanes."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    key = (kernel, index, stream, wp, elem_bytes)
    if key not in _wide_slabs:
        per_sm = getattr(lib, f"sstts_{kernel}_wide_blocks_per_sm")(int(elem_bytes == 4))
        if per_sm < 1:
            raise RuntimeError(f"{kernel} wide kernel: no block fits an SM ({per_sm})")
        n = per_sm * torch.cuda.get_device_properties(device).multi_processor_count
        size = gl_tiles.wide_slab_bytes(wp, elem_bytes, kernel == "gl_fused")
        _wide_slabs[key] = (torch.empty(n, size, dtype=torch.uint8, device=device), n)
    return _wide_slabs[key]


def _aligned(*tensors) -> None:
    """TMA and cp.async read from 16-byte aligned tensors."""
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("the Griffin-Lim kernels need 16-byte aligned tensors")


def _kernel(frames, mag2, w_fwd, wss2d, w_len, hop, d_max, prev, momentum,
            w_fwd_t=None):
    bt, n_frames, wp = frames.shape
    L = mag2.shape[-1]
    hp = L // 2
    dtype = _loop_dtype("fused_reproject_analyze", frames, mag2, w_fwd, prev, w_fwd_t)
    if tuple(w_fwd.shape) != (wp, L) or tuple(wss2d.shape) != (n_frames, wp):
        raise ValueError(
            f"gl_semi: w_fwd {tuple(w_fwd.shape)} / wss2d {tuple(wss2d.shape)}"
            f" do not match frames {tuple(frames.shape)}, mag2 {tuple(mag2.shape)}"
        )
    lib = build.load("gl_semi", _SIGNATURES)
    cfg = _config(lib, "gl_semi", wp, hp, w_len, d_max, False, dtype)
    frames = frames.contiguous()
    mag2 = mag2.contiguous()
    if w_fwd_t is None:
        w_fwd_t = gl_tiles.k_major(w_fwd)
    wss2d = wss2d.float().contiguous()
    prev = None if prev is None else prev.contiguous()
    _aligned(frames, mag2, w_fwd_t, wss2d, prev)
    q = torch.empty_like(mag2)
    s = None if prev is None else torch.empty_like(mag2)
    slabs, n_slabs = (
        wide_scratch(lib, "gl_semi", frames.device, wp, frames.element_size())
        if cfg == "wide" else (None, 0)
    )
    args = _GlArgs(
        frames.data_ptr(), mag2.data_ptr(), w_fwd.data_ptr(), wss2d.data_ptr(),
        None if prev is None else prev.data_ptr(), q.data_ptr(),
        None if s is None else s.data_ptr(),
        bt, n_frames, wp, hp, w_len, hop, d_max, float(momentum),
        w_fwd_t.data_ptr(), None if slabs is None else slabs.data_ptr(), n_slabs,
        int(dtype == torch.float32),
    )
    launch = lib.sstts_gl_semi_wide if cfg == "wide" else lib.sstts_gl_semi
    rc = launch(ctypes.byref(args), torch.cuda.current_stream(frames.device).cuda_stream)
    build.check(lib, rc, "fused_reproject_analyze")
    return q, s


def reproject_analyze(
    frames, mag2, w_fwd, wss2d, w_len, hop, d_max, prev=None, momentum=0.0,
    w_fwd_t=None,
):
    """Device dispatch for the kernel's function (see module docstring);
    counts CUDA launches in `reproject_analyze.launches`.  Inference-only:
    raises when grad mode is on and an input requires grad.  `w_fwd_t` is
    `gl_tiles.k_major(w_fwd)`, the layout the kernel reads; a loop passes it
    once instead of transposing every iteration."""
    require_no_grad("fused_reproject_analyze", frames, mag2, w_fwd, wss2d, prev)
    if prev is not None and momentum <= 0.0:
        prev = None
    if frames.device.type == "cpu":
        return reproject_analyze_plain(
            frames, mag2, w_fwd, wss2d, w_len, hop, d_max, prev, momentum
        )
    if frames.device.type != "cuda":
        raise NotImplementedError(f"fused_reproject_analyze on {frames.device.type}")
    out = _kernel(frames, mag2, w_fwd, wss2d, w_len, hop, d_max, prev, momentum,
                  w_fwd_t)
    reproject_analyze.launches += 1
    return out


reproject_analyze.launches = 0


def _patch_edges(qn, sn, slab_rows, mag3, w_fwd, plan, n_frames, hp, p3=None,
                 momentum=0.0):
    """Exactly recompute the few rows whose reprojected frames receive
    reflect-pad mirror values (the kernels leave them wss-masked), as the
    JAX package's `_patch_edges` and `fused_reproject_analyze` (420-483) do.

    `slab_rows(lo, hi)` returns the pre-mirror reprojected f32 frames rows
    [lo, hi).  Each side's slab holds every run's target and source rows;
    its mirror runs, GEMM2 and renorm (with momentum when `p3` is given)
    are redone in plain torch and written over qn (and sn) in place.
    Returns (qn, sn).
    """
    runs = plan["runs"]
    if not runs:
        return qn, sn
    half_t = n_frames // 2
    head_end = max([max(r[0], r[3]) for r in runs if r[0] < half_t], default=-1) + 1
    tail_start = min([min(r[0], r[3]) for r in runs if r[0] >= half_t], default=n_frames)
    dtype = qn.dtype
    m32 = float(np.float32(momentum))
    w32 = w_fwd.float()

    def fix(rows_lo, rows_hi, local_runs):
        slab = apply_mirror_runs(slab_rows(rows_lo, rows_hi), local_runs)
        s32 = slab.to(dtype).float() @ w32
        mags = mag3[:, rows_lo:rows_hi]
        if p3 is not None:
            ex = s32 + m32 * (s32 - p3[:, rows_lo:rows_hi].float())
            return renorm(ex, mags, hp, dtype), s32.to(dtype)
        return renorm(s32, mags, hp, dtype), None

    if head_end > tail_start:  # tiny frame counts: the slabs overlap
        return fix(0, n_frames, runs)
    if head_end > 0:
        q_h, s_h = fix(0, head_end, [r for r in runs if r[0] < head_end])
        qn[:, :head_end] = q_h
        if sn is not None:
            sn[:, :head_end] = s_h
    if tail_start < n_frames:
        local = [
            (r[0] - tail_start, r[1], r[2], r[3] - tail_start, r[4], r[5])
            for r in runs
            if r[0] >= tail_start
        ]
        q_t, s_t = fix(tail_start, n_frames, local)
        qn[:, tail_start:] = q_t
        if sn is not None:
            sn[:, tail_start:] = s_t
    return qn, sn


def fused_reproject_analyze(
    frames: torch.Tensor,
    mag2: torch.Tensor,
    w_fwd: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int,
    length: int,
    prev: Optional[torch.Tensor] = None,
    momentum: float = 0.0,
    wss2d: Optional[torch.Tensor] = None,
    w_fwd_t: Optional[torch.Tensor] = None,
):
    """Reprojection + analysis GEMM + renorm, with exact edge rows.

    frames (..., n_frames, wp), mag2 (..., n_frames, 2*hp), w_fwd
    (wp, 2*hp), all in the loop dtype.  Returns q' or, with momentum,
    (q', s) — the JAX function's contract.  `wss2d` is the plan's envelope
    padded to wp lanes on the frames' device; a loop passes it once
    instead of uploading it every iteration, and likewise `w_fwd_t`, the
    CUDA kernel's layout of w_fwd (`gl_tiles.k_major`).
    """
    *batch, n_frames, wp = frames.shape
    L = mag2.shape[-1]
    plan = band_plan(n_fft, hop, win_length, n_frames, length)
    w_len, d_max = plan["w_len"], plan["d_max"]
    with_momentum = prev is not None and momentum > 0.0
    f3 = frames.reshape(-1, n_frames, wp)
    b_total = f3.shape[0]
    mag3 = mag2.reshape(-1, n_frames, L).expand(b_total, n_frames, L)
    p3 = (
        prev.reshape(-1, n_frames, L).expand(b_total, n_frames, L)
        if with_momentum
        else None
    )
    if wss2d is None:
        wss2d = padded_wss2d(plan, wp, frames.device)
    w_fwd = w_fwd.to(frames.dtype)
    qn, sn = reproject_analyze(
        f3, mag3, w_fwd, wss2d, w_len, hop, d_max, p3, momentum, w_fwd_t
    )
    qn, sn = _patch_edges(
        qn, sn,
        lambda lo, hi: shift_add_rows(f3, w_len, hop, d_max, lo, hi) * wss2d[lo:hi],
        mag3, w_fwd, plan, n_frames, L // 2, p3, momentum,
    )
    qn = qn.reshape(*batch, n_frames, L)
    if with_momentum:
        return qn, sn.reshape(*batch, n_frames, L)
    return qn


# ------------------------------------------------------------- kernel B5 --


class _GlFusedArgs(ctypes.Structure):
    """Mirror of `GlFusedArgs` in csrc/gl_fused.cu (same field order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("q", "mag2", "w_inv", "w_fwd", "wss2d", "frames", "q_out")
    ] + [
        (name, ctypes.c_int)
        for name in ("Bt", "T", "wp", "hp", "w_len", "hop", "d_max", "n_slabs")
    ] + [
        (name, ctypes.c_void_p) for name in ("w_inv_t", "w_fwd_t", "slab_free")
    ] + [("f32", ctypes.c_int)]


_FUSED_SIGNATURES = {
    "sstts_gl_fused": ([ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "sstts_gl_fused_smem_bytes": ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "sstts_gl_fused_wide": ([ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int),
    "sstts_gl_fused_wide_smem_bytes": ([ctypes.c_int, ctypes.c_int], ctypes.c_int),
    "sstts_gl_fused_wide_blocks_per_sm": ([ctypes.c_int], ctypes.c_int),
}

#: (device index, wp) -> (scratch, flags): GEMM1's f32 slabs, one per SM, and
#: the flag of each (1 = free), kept between launches.  A block of kernel B5
#: takes a free slab and gives it back before it ends, so launches on any
#: stream may share them.  A SM holds one block of B5 at a time; the library
#: refuses a launch if the card could hold more blocks than there are slabs.
_slabs = {}


def fused_scratch(device: torch.device, wp: int):
    """The slabs and flags of `device` for rows of `wp` lanes."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), wp)
    if key not in _slabs:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _slabs[key] = (
            torch.empty(n, gl_tiles.slab_floats(wp), dtype=torch.float32, device=device),
            torch.ones(n, dtype=torch.int32, device=device),
        )
    return _slabs[key]


def gl_iteration_plain(
    q: torch.Tensor,
    mag2: torch.Tensor,
    w_inv: torch.Tensor,
    w_fwd: torch.Tensor,
    wss2d: torch.Tensor,
    w_len: int,
    hop: int,
    d_max: int,
) -> torch.Tensor:
    """Kernel B5's function in plain torch, without the edge repair.

    q, mag2 (Bt, T, 2*hp) and w_inv (2*hp, wp), w_fwd (wp, 2*hp) in the
    loop dtype; wss2d (T, wp) f32.  GEMM1's frames stay f32 through the
    shift-add (unlike "semi" and "split", which round them to the loop
    dtype); the reprojected frames round to the loop dtype before GEMM2.
    Both products are exact f32 over the operands, i.e. the tensor-core
    product with f32 accumulation.
    """
    n_frames = q.shape[-2]
    frames = q.float() @ w_inv.float()
    acc = shift_add_rows(frames, w_len, hop, d_max, 0, n_frames)
    fr = (acc * wss2d).to(q.dtype)
    s32 = fr.float() @ w_fwd.float()
    return renorm(s32, mag2, mag2.shape[-1] // 2, q.dtype)


def _fused_kernel(q, mag2, w_inv, w_fwd, wss2d, w_len, hop, d_max,
                  w_inv_t=None, w_fwd_t=None):
    bt, n_frames, L = q.shape
    hp, wp = L // 2, w_inv.shape[1]
    dtype = _loop_dtype("fused_gl_iteration", q, mag2, w_inv, w_fwd, w_inv_t, w_fwd_t)
    if (
        tuple(w_inv.shape) != (L, wp)
        or tuple(w_fwd.shape) != (wp, L)
        or tuple(wss2d.shape) != (n_frames, wp)
        or tuple(mag2.shape) != tuple(q.shape)
    ):
        raise ValueError(
            f"gl_fused: q {tuple(q.shape)}, mag2 {tuple(mag2.shape)}, w_inv "
            f"{tuple(w_inv.shape)}, w_fwd {tuple(w_fwd.shape)}, wss2d "
            f"{tuple(wss2d.shape)} do not match"
        )
    lib = build.load("gl_fused", _FUSED_SIGNATURES)
    cfg = _config(lib, "gl_fused", wp, hp, w_len, d_max, True, dtype)
    q = q.contiguous()
    mag2 = mag2.contiguous()
    if w_inv_t is None:
        w_inv_t = gl_tiles.k_major(w_inv)
    if w_fwd_t is None:
        w_fwd_t = gl_tiles.k_major(w_fwd)
    wss2d = wss2d.float().contiguous()
    _aligned(q, mag2, w_inv_t, w_fwd_t, wss2d)
    if cfg == "wide":
        scratch, n_slabs = wide_scratch(lib, "gl_fused", q.device, wp, q.element_size())
        flags = None
    else:
        scratch, flags = fused_scratch(q.device, wp)
        n_slabs = scratch.shape[0]
    out = torch.empty_like(q)
    args = _GlFusedArgs(
        q.data_ptr(), mag2.data_ptr(), w_inv.data_ptr(), w_fwd.data_ptr(),
        wss2d.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        bt, n_frames, wp, hp, w_len, hop, d_max, n_slabs,
        w_inv_t.data_ptr(), w_fwd_t.data_ptr(),
        None if flags is None else flags.data_ptr(), int(dtype == torch.float32),
    )
    launch = lib.sstts_gl_fused_wide if cfg == "wide" else lib.sstts_gl_fused
    rc = launch(ctypes.byref(args), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, rc, "fused_gl_iteration")
    return out


def gl_iteration(q, mag2, w_inv, w_fwd, wss2d, w_len, hop, d_max,
                 w_inv_t=None, w_fwd_t=None):
    """Device dispatch for kernel B5's function (see `gl_iteration_plain`);
    counts CUDA launches in `gl_iteration.launches`.  Inference-only:
    raises when grad mode is on and an input requires grad.  `w_inv_t` and
    `w_fwd_t` are `gl_tiles.k_major` of the two matrices, the layouts the
    kernel reads; a loop passes them once."""
    require_no_grad("fused_gl_iteration", q, mag2, w_inv, w_fwd, wss2d)
    if q.device.type == "cpu":
        return gl_iteration_plain(q, mag2, w_inv, w_fwd, wss2d, w_len, hop, d_max)
    if q.device.type != "cuda":
        raise NotImplementedError(f"fused_gl_iteration on {q.device.type}")
    out = _fused_kernel(q, mag2, w_inv, w_fwd, wss2d, w_len, hop, d_max,
                        w_inv_t, w_fwd_t)
    gl_iteration.launches += 1
    return out


gl_iteration.launches = 0


def _edge_frames(q3, w_inv, w_len, hop, d_max, rows_lo, rows_hi):
    """Exact pre-envelope reprojected frames rows [rows_lo, rows_hi),
    rebuilt from the spectrum: GEMM1 (exact f32 products) on the thin q
    neighbourhood, then the shift-add (the JAX `_edge_frames_xla`)."""
    n_frames = q3.shape[1]
    g_lo = max(0, rows_lo - d_max)
    g_hi = min(n_frames, rows_hi + d_max)
    f1 = q3[:, g_lo:g_hi].float() @ w_inv.float()
    return shift_add_rows(f1, w_len, hop, d_max, rows_lo - g_lo, rows_hi - g_lo)


def fused_gl_iteration(
    q: torch.Tensor,
    mag2: torch.Tensor,
    w_inv: torch.Tensor,
    w_fwd: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int,
    length: int,
    wss2d: Optional[torch.Tensor] = None,
    w_inv_t: Optional[torch.Tensor] = None,
    w_fwd_t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One whole Griffin-Lim iteration q -> q' (the JAX
    `fused_gl_iteration`, 491-645): kernel B5 (its plain version on the
    CPU), then the exact repair of the reflect-pad edge rows in plain torch.

    q, mag2 (..., n_frames, 2*hp) in the loop dtype; w_inv (2*hp, wp),
    w_fwd (wp, 2*hp).  Classic iterations only: momentum is refused by
    `griffin_lim`, as in JAX.  `wss2d`, `w_inv_t` and `w_fwd_t` as in
    `fused_reproject_analyze`: constants a loop passes once.
    """
    *batch, n_frames, L = q.shape
    wp = w_inv.shape[1]
    plan = band_plan(n_fft, hop, win_length, n_frames, length)
    w_len, d_max = plan["w_len"], plan["d_max"]
    dtype = q.dtype
    q3 = q.reshape(-1, n_frames, L)
    b_total = q3.shape[0]
    mag3 = mag2.reshape(-1, n_frames, L).expand(b_total, n_frames, L)
    if wss2d is None:
        wss2d = padded_wss2d(plan, wp, q.device)
    w_inv = w_inv.to(dtype)
    w_fwd = w_fwd.to(dtype)
    qn = gl_iteration(q3, mag3, w_inv, w_fwd, wss2d, w_len, hop, d_max,
                      w_inv_t, w_fwd_t)
    qn, _ = _patch_edges(
        qn, None,
        lambda lo, hi: _edge_frames(q3, w_inv, w_len, hop, d_max, lo, hi) * wss2d[lo:hi],
        mag3, w_fwd, plan, n_frames, L // 2,
    )
    return qn.reshape(*batch, n_frames, L)
