"""What the wrappers of the Griffin-Lim kernels B2 and B5 reckon on the host.

The tile constants of the CUDA sources (`csrc/gl_tail.cuh`, `gl_semi.cu`,
`gl_fused.cu`) and the shared-memory and scratch reckoning built on them:
the wrappers in `dsp/gl_fused.py` refuse a shape with `check_shapes` before
anything is built or launched, and size B5's scratch with `slab_floats`; the
tests hold the constants to the sources.  Also the constant layout the
wrappers hand the kernels (`k_major`).
"""

from __future__ import annotations

import torch

#: Mirrors of the constants in csrc/gl_tail.cuh and csrc/gl_fused.cu.
BM = 64  # frames per block
BN = 64  # bins per GEMM2 tile (its B operand holds 2 * BN rows)
BK = 64  # lanes of K per ring stage and per panel chunk
STAGES = 5
CHUNK_BYTES = BM * BK * 2
STAGE_BYTES = 2 * BN * BK * 2
F_SLOTS = 4  # groups of F rows in flight in the ring's memory
MAX_PASS = 18  # 32-word passes over a panel row
BARRIER_BYTES = 256
MAX_SMEM = 232448
N1 = 72  # GEMM1 rows a block: BM + 2 * d_max <= N1
M1_TILES = 2
G1_STAGE_BYTES = 2 * M1_TILES * 64 * BK * 2 + N1 * BK * 2
G1_MAX_STAGES = 4


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def k_needed(w_len: int) -> int:
    """K of GEMM2: the window support rounded up to a wgmma K step.  The
    lanes from w_len on are zero in the panel and in w_fwd."""
    return round_up(w_len, 16)


def panel_chunks(w_len: int) -> int:
    return round_up(k_needed(w_len), BK) // BK


def f_rows_fit(w_len: int, d_max: int, elem_bytes: int) -> bool:
    """Whether the rows of F (bf16 frames for B2, f32 for B5) fit: they pass
    through the ring's memory in F_SLOTS groups of 16 / elem_bytes rows, a
    row taking its w_len lanes rounded up to 16 bytes (with two rows to
    spare: a shifted load may reach one row's length past the rows), and no
    shift may reach further than one group."""
    group = 16 // elem_bytes
    return (
        d_max <= group
        and (F_SLOTS * group + 2) * round_up(w_len * elem_bytes, 16)
        <= STAGES * STAGE_BYTES
        and k_needed(w_len) <= MAX_PASS * 64
    )


def tail_smem_bytes(w_len: int) -> int:
    """Dynamic shared memory of a launch of B2 or B5: alignment slack, the
    panel, the ring, the barriers."""
    return 1024 + panel_chunks(w_len) * CHUNK_BYTES + STAGES * STAGE_BYTES + BARRIER_BYTES


def g1_stages(w_len: int) -> int:
    """Stages of B5's GEMM1 ring in the panel's and GEMM2 ring's memory."""
    room = panel_chunks(w_len) * CHUNK_BYTES + STAGES * STAGE_BYTES
    return min(G1_MAX_STAGES, room // G1_STAGE_BYTES)


def slab_floats(wp: int) -> int:
    """f32 values of one slab of B5's scratch (one slab per SM)."""
    return N1 * wp


def check_shapes(kernel: str, wp: int, hp: int, w_len: int, d_max: int,
                 fused: bool = False) -> int:
    """Shared memory of a launch; raises for what the kernels do not take:
    a window support above 1152 samples (18 panel chunks), more than 8
    overlapping frames a side for B2 (hop below about an eighth of the
    window) and more than 4 for B5 (hop below about a fifth of it).  The
    split iteration (`iter_impl="split"`) has none of these limits."""
    if wp % BK or hp % (2 * BN) or w_len > wp:
        raise ValueError(
            f"{kernel} kernel needs wp % {BK} == 0, hp % {2 * BN} == 0 and "
            f"w_len <= wp: {wp}, {hp}, {w_len}"
        )
    smem = tail_smem_bytes(w_len)
    if smem > MAX_SMEM:
        raise NotImplementedError(
            f"{kernel} kernel keeps a {BM} x {k_needed(w_len)} frames panel in "
            f"shared memory ({smem} bytes > {MAX_SMEM}); a window support above "
            f"{(MAX_SMEM - tail_smem_bytes(0)) // CHUNK_BYTES * BK} samples is "
            "not supported; iter_impl='split' takes it"
        )
    if not f_rows_fit(w_len, d_max, 4 if fused else 2):
        raise NotImplementedError(
            f"{kernel} kernel: d_max={d_max} reaches beyond one group of "
            f"{4 if fused else 8} rows, or rows of {w_len} lanes do not fit in "
            f"its ring ({STAGES * STAGE_BYTES} bytes); iter_impl='split' takes it"
        )
    if fused and (BM + 2 * d_max > N1 or g1_stages(w_len) < 2):
        raise NotImplementedError(
            f"{kernel} kernel: d_max={d_max} halo rows beyond its {N1}-row GEMM1 "
            f"tile, or a window support ({w_len}) too short for its GEMM1 ring; "
            "iter_impl='semi' or 'split' takes it"
        )
    return smem


def k_major(w: torch.Tensor) -> torch.Tensor:
    """The constant layout the kernels take a weight matrix in: transposed
    and contiguous, so that K (the dimension a product sums over) is the
    inner one for both wgmma operands."""
    return w.t().contiguous()
