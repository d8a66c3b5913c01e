"""Banded frames-domain reprojection for the Griffin-Lim loop: kernel B1.

Port of `sstts/dsp/reproject.py` (43-190, 207-367).  Between the two DFT
GEMMs of a Griffin-Lim iteration, overlap-add -> window-sum normalise ->
reflect pad -> re-frame collapses into a banded shift-add over the synthesis
frames F:

    F'[t, j] = inv_wss[lo + t*hop + j] * sum_{d=-D..D} F[t - d, j + d*hop],

plus mirrored copies (librosa's reflect padding) at the few edge positions
whose sample index falls outside the signal.  `band_plan` is a copy of the
JAX package's host-side plan (`_band_plan`), so the port needs none of it.

`reproject_frames` is kernel B1's wrapper: a CPU tensor runs
`reproject_frames_plain` (the JAX package's XLA formulation), a CUDA tensor
launches `sstts_torch/csrc/reproject.cu` or raises.  The kernel applies the
mirror runs itself, in the same launch, from the run table (`run_table`,
made once a geometry); the JAX package applies them in XLA after its
kernel.  The host picks the kernel's ring (`ring_config`) and its strips of
rows (`strip_count`: about one wave of blocks, and every mirror run inside
the strip of the block that applies it).  Where no ring fits shared memory
(f32 rows of 2048 lanes at D >= 13) inside every geometry B2 and B5 take,
the same launch runs the direct configuration, whose terms come from L2
(`config`).
"""

from __future__ import annotations

import bisect
import ctypes
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sstts_torch.dsp.stft import hann_window, pad_center
from sstts_torch.ops import build, require_no_grad


@functools.lru_cache(maxsize=None)
def band_plan(
    n_fft: int, hop: int, win_length: int, n_frames: int, length: int
) -> dict:
    """Static host-side plan: geometry, normalization, mirror runs.

    Returns host numpy only (cached).  `wss2d[t, j]` is the inverse
    window-sum envelope at frame position (t, j), zeroed outside the
    signal; each run (t, a, b, t_src, src_lo, src_hi) sets
    out[t, a:b] = flip(out[t_src, src_lo:src_hi]).
    """
    window = pad_center(hann_window(win_length), n_fft).astype(np.float64)
    nz = np.nonzero(window)[0]
    lo, hi = int(nz[0]), int(nz[-1]) + 1
    w_len = hi - lo
    start = n_fft // 2 - lo
    d_max = (w_len - 1) // hop
    t_idx = np.arange(n_frames)

    w2 = window**2
    total = (n_frames - 1) * hop + n_fft
    wss = np.zeros(total, np.float64)
    for i in range(n_frames):
        wss[i * hop : i * hop + n_fft] += w2
    inv_full = np.where(wss > 1e-10, 1.0 / np.maximum(wss, 1e-10), 1.0)
    pos = lo + t_idx[:, None] * hop + np.arange(w_len)[None, :]  # (T, w_len)
    s = pos - n_fft // 2  # signal sample index at each frame position
    wss2d = inv_full[pos] * ((s >= 0) & (s < length))

    runs: List[Tuple[int, int, int, int, int, int]] = []

    def add_runs(t: int, js: np.ndarray, u_mirror: np.ndarray) -> None:
        if js.size == 0:
            return
        t_src = np.minimum(n_frames - 1, u_mirror // hop)
        j_src = u_mirror - t_src * hop
        # group contiguous j with equal t_src (j_src then descends by 1)
        cut = np.flatnonzero(np.diff(t_src)) + 1
        for grp_j, grp_src_t, grp_src_j in zip(
            np.split(js, cut), np.split(t_src, cut), np.split(j_src, cut)
        ):
            runs.append(
                (
                    t,
                    int(grp_j[0]),
                    int(grp_j[-1]) + 1,
                    int(grp_src_t[0]),
                    int(grp_src_j[-1]),
                    int(grp_src_j[0]) + 1,
                )
            )

    U = start + length
    for t in range(n_frames):
        u = t * hop + np.arange(w_len)
        left = np.flatnonzero(u < start)
        if left.size:
            add_runs(t, left, 2 * start - u[left])
        right = np.flatnonzero(u >= U)
        if right.size:
            add_runs(t, right, 2 * (U - 1) - u[right])

    return {
        "lo": lo,
        "w_len": w_len,
        "start": start,
        "d_max": d_max,
        "wss2d": wss2d.astype(np.float32),
        "runs": tuple(runs),
    }


def padded_wss2d(plan: dict, wp: int, device) -> torch.Tensor:
    """`plan["wss2d"]` zero-padded to `wp` lanes, f32 on `device`."""
    wss = torch.as_tensor(plan["wss2d"], device=device)
    return F.pad(wss, (0, wp - plan["w_len"]))


def apply_mirror_runs(out: torch.Tensor, runs) -> torch.Tensor:
    """Overwrite the edge positions with their reflect-pad mirrors, in run
    order (a run may read a row an earlier run wrote).  In place."""
    for t, a, b, t_src, src_lo, src_hi in runs:
        out[..., t, a:b] = out[..., t_src, src_lo:src_hi].flip(-1)
    return out


def shift_add_rows(
    frames: torch.Tensor,
    w_len: int,
    hop: int,
    d_max: int,
    rows_lo: int,
    rows_hi: int,
) -> torch.Tensor:
    """sum_d F[t - d, j + d*hop] for rows [rows_lo, rows_hi), f32.

    `frames` is (..., n_frames, wp) with wp >= w_len; source lanes outside
    the window support [0, w_len) and rows outside [0, n_frames) count as
    zero.  The terms are summed d = 0 first, then d = -D..D without 0, the
    order of the Pallas kernel and of its CUDA port.
    """
    n_frames, wp = frames.shape[-2], frames.shape[-1]
    col_pad = d_max * hop
    g_lo = max(0, rows_lo - d_max)
    g_hi = min(n_frames, rows_hi + d_max)
    f1 = frames[..., g_lo:g_hi, :w_len].float()
    top = g_lo - (rows_lo - d_max)
    bot = (rows_hi + d_max) - g_hi
    f1 = F.pad(f1, (col_pad, col_pad + wp - w_len, top, bot))
    H = rows_hi - rows_lo

    def term(d):
        return f1[
            ...,
            d_max - d : d_max - d + H,
            col_pad + d * hop : col_pad + d * hop + wp,
        ]

    acc = term(0)
    for d in range(-d_max, d_max + 1):
        if d:
            acc = acc + term(d)
    return acc


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _geometry(frames: torch.Tensor, n_fft, hop, win_length, length):
    """(plan, w_len, width): `frames` is (..., n_frames, width) with width
    the window support or its 128-lane padding."""
    n_frames, width = frames.shape[-2], frames.shape[-1]
    plan = band_plan(n_fft, hop, win_length, n_frames, length)
    w_len = plan["w_len"]
    if width not in (w_len, _round_up(w_len, 128)):
        raise ValueError(
            f"reprojection frames width {width}: expected the window support "
            f"{w_len} or its 128-lane padding {_round_up(w_len, 128)}"
        )
    return plan, w_len, width


def reproject_frames_plain(
    frames: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int,
    length: int,
    wss2d: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B1's plain version, the JAX package's XLA formulation
    (`reproject_frames`, 124-157): the shift-add times the envelope in f32,
    then the mirror runs, then a cast to the input dtype.  `frames` is
    (..., n_frames, width); lanes [w_len, width) of the result are zero.
    `wss2d` is the plan's envelope padded to `width`, on the frames' device
    (a loop passes it once)."""
    plan, w_len, width = _geometry(frames, n_fft, hop, win_length, length)
    n_frames = frames.shape[-2]
    acc = shift_add_rows(frames, w_len, hop, plan["d_max"], 0, n_frames)
    if wss2d is None:
        wss2d = padded_wss2d(plan, width, frames.device)
    out = apply_mirror_runs(acc * wss2d, plan["runs"])
    return out.to(frames.dtype)


class _ReprojectArgs(ctypes.Structure):
    """Mirror of `ReprojectArgs` in csrc/reproject.cu (same field order)."""

    _fields_ = [(n, ctypes.c_void_p) for n in ("frames", "wss2d", "runs", "out")] + [
        (n, ctypes.c_int)
        for n in ("Bt", "T", "wp", "w_len", "hop", "d_max", "strips", "group", "stages",
                  "n_runs")
    ]


_SIGNATURES = {
    "sstts_reproject": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "sstts_reproject_smem_bytes": ([ctypes.c_int] * 4, ctypes.c_int),
    "sstts_reproject_threads": ([ctypes.c_int] * 2, ctypes.c_int),
    "sstts_reproject_rows": ([], ctypes.c_int),
    "sstts_reproject_blocks_per_sm": ([ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
    "sstts_reproject_direct": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
                               ctypes.c_int),
    "sstts_reproject_direct_blocks_per_sm": ([ctypes.c_int], ctypes.c_int),
}

#: The direct configuration (terms read from L2, no ring) takes the shapes
#: no ring holds up to these: every Griffin-Lim geometry of n_fft <= 2048
#: with at most 16 overlapping frames a side, which B2 and B5 take too.
DIRECT_MAX_LANES = 2048
DIRECT_MAX_D = 16

#: A ring stage holds the fewest rows (a power of two) that make at least
#: this many bytes: one bulk copy and one barrier a stage.
STAGE_BYTES = 16384

#: Stages the ring holds beyond the band an output row reads, so that the
#: copies run ahead of the arithmetic.
PREFETCH_STAGES = 1

#: The shortest strip of rows a block walks when the grid is cut to fill
#: the card (a strip re-reads 2 D halo rows).
MIN_STRIP = 32


def library() -> ctypes.CDLL:
    """This checkout's build of csrc/reproject.cu, bound."""
    return build.load("reproject", _SIGNATURES)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the library's C functions on `lib` (a build of
    csrc/reproject.cu from another tree)."""
    for fn, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def ring_candidates(row_bytes: int, d_max: int, rows: int):
    """(rows a stage G, stages NS) in the order the wrapper tries them: the
    stage of at least STAGE_BYTES with PREFETCH_STAGES stages ahead, then
    less prefetch, then smaller stages.  A consumer computes `rows` output rows
    together, which read the 2 D + rows input rows around them: NS >=
    ceil((2 D + rows - 1) / G) + 1, so that the stage a consumer waits for
    never waits for one it has not released."""
    g = 1
    while g * row_bytes < STAGE_BYTES:
        g *= 2
    out = []
    while g >= 1:
        for pf in range(PREFETCH_STAGES, -1, -1):
            out.append((g, -(-(2 * d_max + rows - 1) // g) + 1 + pf))
        g //= 2
    return out


def ring_config(smem_bytes, wp: int, elem_bytes: int, d_max: int,
                rows: int) -> Tuple[int, int, int]:
    """(G, NS, shared-memory bytes) of the first of `ring_candidates` whose
    block fits the card by `smem_bytes(wp, elem_bytes, G, NS)`, the
    library's own count.  NotImplementedError if none does."""
    for g, ns in ring_candidates(wp * elem_bytes, d_max, rows):
        smem = smem_bytes(wp, elem_bytes, g, ns)
        if smem <= build.MAX_SMEM:
            return g, ns, smem
    raise NotImplementedError(
        f"reproject_frames kernel: a ring of the {2 * d_max + rows} rows of {wp} lanes "
        f"that {rows} output rows read ({elem_bytes}-byte values, D = {d_max}) exceeds "
        f"{build.MAX_SMEM} bytes of shared memory"
    )


def strip_starts(n_frames: int, strips: int) -> List[int]:
    """First row of each strip of an utterance, and n_frames after the last:
    strip s holds rows [s T / strips, (s + 1) T / strips)."""
    return [s * n_frames // strips for s in range(strips + 1)]


def runs_fit(runs, n_frames: int, strips: int) -> bool:
    """Every mirror run reads a row of the strip that holds its own: the
    block of that strip applies it, in run order, after its rows are
    stored."""
    starts = strip_starts(n_frames, strips)

    def strip_of(row: int) -> int:
        return bisect.bisect_right(starts, row) - 1

    return all(strip_of(t) == strip_of(t_src) for t, _, _, t_src, _, _ in runs)


def strip_count(batch: int, n_frames: int, runs, slots: int) -> int:
    """Strips an utterance: as many as fill the `slots` blocks the card
    holds at once (one wave) but none shorter than MIN_STRIP rows, then
    fewer until every mirror run lies inside one strip (one strip always
    holds them)."""
    strips = max(1, min(slots // max(batch, 1), n_frames // MIN_STRIP))
    while strips > 1 and not runs_fit(runs, n_frames, strips):
        strips -= 1
    return strips


@functools.lru_cache(maxsize=64)
def run_table(runs: tuple, device: torch.device) -> torch.Tensor:
    """The mirror runs as the kernel reads them, (n_runs, 6) int32 rows
    (t, a, b, t_src, src_lo, src_hi) on `device`, made once a geometry
    and copied from pinned memory, so that the host does not wait."""
    table = torch.tensor(runs, dtype=torch.int32).reshape(-1, 6)
    if device.type == "cuda":
        table = table.pin_memory().to(device, non_blocking=True)
    return table


def config(smem_bytes, wp: int, elem_bytes: int, d_max: int, rows: int):
    """(G, NS) of the ring (`ring_config`), or None for the direct
    configuration where no ring fits and the shape is inside
    DIRECT_MAX_LANES and DIRECT_MAX_D; NotImplementedError beyond both."""
    try:
        return ring_config(smem_bytes, wp, elem_bytes, d_max, rows)[:2]
    except NotImplementedError:
        if wp <= DIRECT_MAX_LANES and d_max <= DIRECT_MAX_D:
            return None
        raise


@functools.lru_cache(maxsize=64)
def _slots(lib, wp: int, elem_bytes: int, group: int, stages: int,
           device: torch.device) -> int:
    """Blocks of this shape the card holds at once: its SMs times the
    library's blocks an SM (stages 0: the direct configuration)."""
    args = _ReprojectArgs(wp=wp, group=group, stages=stages)
    per_sm = (lib.sstts_reproject_direct_blocks_per_sm(int(elem_bytes == 2)) if stages == 0
              else lib.sstts_reproject_blocks_per_sm(ctypes.byref(args), int(elem_bytes == 2)))
    if per_sm < 1:
        raise RuntimeError(f"reproject_frames kernel: no block fits an SM ({per_sm})")
    return per_sm * torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous on a 16-byte aligned address (bulk copies and 16-byte
    loads need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch(lib, f3, wss2d, w_len, hop, d_max, runs):
    """Launch `lib`'s kernel B1 (`library()`, or another `bind`-ed build) on
    f3 (Bt, T, wp) bf16 or f32, wp a multiple of 8, with its mirror runs
    `runs` (`band_plan`'s); returns the reprojected frames.  The ring
    kernel where its ring fits shared memory, else the direct one inside
    DIRECT_MAX_LANES and DIRECT_MAX_D (`config`); NotImplementedError,
    before any launch, beyond both."""
    if f3.dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"reproject_frames kernel: dtype {f3.dtype}")
    bt, n_frames, wp = f3.shape
    if wp % 8 or tuple(wss2d.shape) != (n_frames, wp):
        raise ValueError(
            f"reproject_frames kernel: frames {tuple(f3.shape)}, wss2d "
            f"{tuple(wss2d.shape)} (needs wp % 8 == 0 and wss2d (T, wp))"
        )
    es = f3.element_size()
    ring = config(lib.sstts_reproject_smem_bytes, wp, es, d_max, lib.sstts_reproject_rows())
    group, stages = ring or (0, 0)
    slots = _slots(lib, wp, es, group, stages, f3.device)
    strips = strip_count(bt, n_frames, runs, slots)
    table = run_table(tuple(runs), f3.device)
    f3 = _aligned(f3)
    wss2d = _aligned(wss2d.float())
    out = torch.empty_like(f3)
    args = _ReprojectArgs(
        f3.data_ptr(), wss2d.data_ptr(), table.data_ptr() if len(runs) else None,
        out.data_ptr(), bt, n_frames, wp, w_len, hop, d_max, strips, group, stages,
        len(runs),
    )
    kernel = lib.sstts_reproject if ring else lib.sstts_reproject_direct
    rc = kernel(
        ctypes.byref(args), int(f3.dtype == torch.bfloat16),
        torch.cuda.current_stream(f3.device).cuda_stream,
    )
    build.check(lib, rc, "reproject_frames")
    return out


def reproject_frames(
    frames: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int,
    length: int,
    wss2d: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B1 with its mirror runs, one launch (see the module
    docstring); counts CUDA launches in `reproject_frames.launches`.
    Inference-only: raises when grad mode is on and the input requires
    grad."""
    require_no_grad("reproject_frames", frames, wss2d)
    if frames.device.type == "cpu":
        return reproject_frames_plain(frames, n_fft, hop, win_length, length, wss2d)
    if frames.device.type != "cuda":
        raise NotImplementedError(f"reproject_frames on {frames.device.type}")
    plan, w_len, width = _geometry(frames, n_fft, hop, win_length, length)
    *batch, n_frames, _ = frames.shape
    wp = _round_up(w_len, 128)
    f3 = frames.reshape(-1, n_frames, width)
    if width != wp:  # the kernel's layout is the 128-lane-padded one
        f3 = F.pad(f3, (0, wp - width))
    if wss2d is None or wss2d.shape[-1] != wp:
        wss2d = padded_wss2d(plan, wp, frames.device)
    out = launch(library(), f3, wss2d, w_len, hop, plan["d_max"], plan["runs"])
    reproject_frames.launches += 1
    return out[..., :width].reshape(*batch, n_frames, width)


reproject_frames.launches = 0


def reproject(
    frames: torch.Tensor,
    n_fft: int,
    hop: int,
    win_length: int,
    length: int,
    impl: str = "auto",
    wss2d: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reprojected frames in the input dtype, as the JAX `reproject`
    (335-367): "auto" is kernel B1 (its plain version on the CPU), "xla"
    the no-kernel banded formulation in torch ops on any device.  Both take
    the window-support width and the 128-lane-padded one."""
    if impl == "auto":
        return reproject_frames(frames, n_fft, hop, win_length, length, wss2d)
    if impl == "xla":
        return reproject_frames_plain(frames, n_fft, hop, win_length, length, wss2d)
    raise ValueError(f"unknown reproject impl {impl!r}; expected 'auto' or 'xla'")
