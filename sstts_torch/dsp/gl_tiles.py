"""What the wrappers of the Griffin-Lim kernels B2 and B5 reckon on the host.

Each kernel comes in two tile configurations of the same function, chosen
by `config` from the geometry and the loop dtype before anything is built
or launched:

- "panel" (`csrc/gl_tail.cuh`): the 64-frame panel resident in shared
  memory beside a TMA ring of w_fwd, wgmma, clusters of two.  bf16 only,
  a window support up to 1152 lanes (B5: 1137), D <= 8 (B5: 4): the
  default geometry and the 16 kHz one.  It is the faster where it fits.
- "wide" (`csrc/gl_wide.cuh`): the panel built once per 64 frames into a
  slab of device memory that stays in L2 and streamed back for each of
  GEMM2's column tiles, mma.sync, bf16 or f32 (three tf32 products).
  Shared memory does not grow with the support; every geometry of
  n_fft <= 2048 (wp <= 2048, 2 hp <= 2304) with D <= 16.

Beyond both, the wrappers raise NotImplementedError by name.  The tile
constants of the sources, the shared-memory and scratch reckoning built on
them (the tests hold the constants to the sources), and the constant layout
the wrappers hand the kernels (`k_major`).
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
    """Shared memory of a launch of the panel configuration; raises for what
    it does not take: a window support above 1152 samples (18 panel
    chunks), more than 8 overlapping frames a side for B2 (hop below about
    an eighth of the window) and more than 4 for B5 (hop below about a
    fifth of it).  `config` sends those to the wide configuration."""
    _check_layout(kernel, wp, hp, w_len)
    smem = tail_smem_bytes(w_len)
    if smem > MAX_SMEM:
        raise NotImplementedError(
            f"{kernel} kernel keeps a {BM} x {k_needed(w_len)} frames panel in "
            f"shared memory ({smem} bytes > {MAX_SMEM}); a window support above "
            f"{(MAX_SMEM - tail_smem_bytes(0)) // CHUNK_BYTES * BK} samples is "
            "not supported by the panel configuration"
        )
    if not f_rows_fit(w_len, d_max, 4 if fused else 2):
        raise NotImplementedError(
            f"{kernel} kernel: d_max={d_max} reaches beyond one group of "
            f"{4 if fused else 8} rows, or rows of {w_len} lanes do not fit in "
            f"its ring ({STAGES * STAGE_BYTES} bytes)"
        )
    if fused and (BM + 2 * d_max > N1 or g1_stages(w_len) < 2):
        raise NotImplementedError(
            f"{kernel} kernel: d_max={d_max} halo rows beyond its {N1}-row GEMM1 "
            f"tile, or a window support ({w_len}) too short for its GEMM1 ring; "
            "the wide configuration takes it"
        )
    return smem


#: Mirrors of the constants in csrc/gl_wide.cuh (namespace wide).
WIDE_THREADS = 256
WIDE_ROWS = 64  # frames a work item: GEMM2's rows
WIDE_G1_ROWS = 96  # B5's GEMM1 rows: 64 + 2 D
WIDE_MAX_D = 16
WIDE_MAX_LANES = 2048  # wp: a window of up to 2048 samples
WIDE_BINS = 128  # bins of a GEMM2 column tile (their re and im columns)
WIDE_LANES = 128  # lanes of a GEMM1 column tile
WIDE_K_BYTES = 64  # bytes of K of an operand row a ring stage
WIDE_ROW_BYTES = WIDE_K_BYTES + 16
WIDE_STAGE_ROWS = WIDE_ROWS + 2 * WIDE_BINS
WIDE_STAGES = 3
WIDE_SMEM = WIDE_STAGES * WIDE_STAGE_ROWS * WIDE_ROW_BYTES
WIDE_K_ALIGN = 32

#: The envelope both configurations cover together: n_fft <= 2048, i.e. a
#: window of up to 2048 samples (wp <= 2048) and up to 1025 bins (hp <=
#: 1152: the f32 loop's unpacked 1025 rounded up to 128), D <= 16.
MAX_HP = 1152


def _check_layout(kernel: str, wp: int, hp: int, w_len: int) -> None:
    if wp % BK or hp % (2 * BN) or w_len > wp:
        raise ValueError(
            f"{kernel} kernel needs wp % {BK} == 0, hp % {2 * BN} == 0 and "
            f"w_len <= wp: {wp}, {hp}, {w_len}"
        )


def wide_smem_bytes(w_len: int, d_max: int) -> int:
    """Dynamic shared memory of a wide launch (the same for B2 and B5, bf16
    and f32), or -1 beyond its envelope; `sstts_gl_*_wide_smem_bytes`."""
    if d_max <= WIDE_MAX_D and round_up(w_len, WIDE_K_ALIGN) <= WIDE_MAX_LANES:
        return WIDE_SMEM
    return -1


def wide_slab_bytes(wp: int, elem_bytes: int, fused: bool) -> int:
    """Bytes of one block's slab in the wide configuration (`slab_bytes` in
    gl_wide.cuh): B5's GEMM1 frames (WIDE_G1_ROWS x wp f32), then the panel
    (WIDE_ROWS x wp values of the loop dtype)."""
    return (WIDE_G1_ROWS * wp * 4 if fused else 0) + WIDE_ROWS * wp * elem_bytes


def panel_fits(wp: int, hp: int, w_len: int, d_max: int, fused: bool,
               dtype: torch.dtype) -> bool:
    """Whether the panel configuration takes the geometry (bf16 only)."""
    try:
        check_shapes("gl", wp, hp, w_len, d_max, fused)
    except NotImplementedError:
        return False
    return dtype == torch.bfloat16


def config(kernel: str, wp: int, hp: int, w_len: int, d_max: int, fused: bool,
           dtype: torch.dtype):
    """("panel" or "wide", shared memory a launch): the panel configuration
    where it fits, else the wide one inside the envelope (n_fft <= 2048,
    D <= 16); NotImplementedError beyond it, ValueError for a layout the
    kernels never take."""
    _check_layout(kernel, wp, hp, w_len)
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"{kernel} kernel: loop dtype {dtype}")
    if panel_fits(wp, hp, w_len, d_max, fused, dtype):
        return "panel", tail_smem_bytes(w_len)
    smem = wide_smem_bytes(w_len, d_max)
    if smem < 0 or wp > WIDE_MAX_LANES or hp > MAX_HP:
        raise NotImplementedError(
            f"{kernel} kernel takes n_fft <= 2048 (a window of up to "
            f"{WIDE_MAX_LANES} samples, 2 hp <= {2 * MAX_HP}) with at most "
            f"{WIDE_MAX_D} overlapping frames a side: wp {wp}, w_len {w_len}, "
            f"hp {hp}, d_max {d_max}; iter_impl='split' takes it where kernel B1's ring fits"
        )
    return "wide", smem


def k_major(w: torch.Tensor) -> torch.Tensor:
    """The constant layout the kernels take a weight matrix in: transposed
    and contiguous, so that K (the dimension a product sums over) is the
    inner one for both wgmma operands."""
    return w.t().contiguous()
