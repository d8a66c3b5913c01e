"""Whole-sequence GRU and its gradient: the port of `sstts/ops/pallas_gru.py`
(kernel B3; `gru_sequence` 69-123 and `gru_sequence_ad` 126-167).

`gru_sequence` dispatches on the tensor's device: a CPU tensor runs the
plain version (`gru_sequence_plain`, the counterpart of JAX's
`gru_sequence_xla` scan oracle); a CUDA tensor launches the hand-written
kernels in `sstts_torch/csrc/gru.cu`, or raises.  There is no fallback from
one to the other.  Layouts match the JAX package: xs (B, T, D), wx (D, 3H),
wh (H, 3H), b (3H,), mask (B, T), gate order r, z, n.

On the card the recurrences come in four kinds, chosen here from H alone
(`kernel_config`, before any launch): at H = 128, the width of every GRU at
the default `Config()`, kernels that hold Wh in registers; at any other H up
to 137, generic kernels that hold Wh in one block's shared memory; past
137, wide kernels that split Wh over a thread-block cluster of C blocks
running a tile of Bt batch rows (`wide_shape`, `wide_rows`: Bt = ceil(B /
the clusters of C the card holds, `WIDE_CLUSTERS`), so that the batch runs
in one wave; C the smallest up to 16, of at most `WIDE_UNITS` = 32 units a
rank where 16 ranks allow it, whose block holds the rows that B = 32 needs),
up to 522; from `GRID_MIN_HIDDEN` = 523, where no cluster's
block holds them, to `MAX_HIDDEN` = 5456, the grid kind: one cooperative
grid of up to 132 blocks a direction, each owning U units of every
sequence (`grid_shape`), the carry (forward) or the step's dgh (backward)
exchanged through a zeroed buffer in device memory with one grid barrier a
step.
Where a block's slice of Wh no longer fits its shared memory (past H =
1419 backward), the block keeps the K range [0, R) of it there and streams
the rest from a packed copy in device memory, tile by tile, once a step
for each 32 rows of the batch.  None stands in for another: a kernel that
fails to build or launch raises, and so does a grid launch that the card
refuses (not all NB blocks resident at once: fewer SMs than NB).
`check_width` refuses a GRU wider than MAX_HIDDEN with NotImplementedError,
from the entry points' checks (`check_arch`) before anything is launched
and again at each launch.

Gradient: when grad mode is on and an input requires grad, the call goes
through `_GRUSequence`, an `autograd.Function`.  Its forward also keeps the
gates r, z, n, the recurrent candidate term hn and the carry before each
step; its backward runs the reverse-time recurrence
(`gru_sequence_backward`: the kernel on the card, `gru_sequence_backward_plain`
on the CPU) and leaves the four large independent products (dxs, dWx, dWh,
db) to torch.matmul, as JAX leaves them to XLA.  Under `no_grad` or
`inference_mode` nothing is kept.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from sstts_torch.ops import build

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "sstts_gru_sequence": ([_P] * 10 + [_I] * 7 + [_P], _I),
    "sstts_gru_sequence_backward": ([_P] * 8 + [_I] * 6 + [_P], _I),
    "sstts_gru_input_proj": ([_P] * 4 + [_I] * 3 + [_P], _I),
    "sstts_gru_recurrence": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "sstts_gru_wide_rows": ([_I] * 3, _I),
    "sstts_gru_wide_smem_bytes": ([_I] * 4, _I),
    "sstts_gru_wide_threads": ([_I] * 4, _I),
    "sstts_gru_wide_active_clusters": ([_I] * 4, _I),
    "sstts_gru_grid_smem_bytes": ([_I] * 2, _I),
    "sstts_gru_grid_resident": ([_I] * 2, _I),
    "sstts_gru_grid_exchange_floats": ([_I] * 3, ctypes.c_longlong),
    "sstts_gru_grid_scratch_floats": ([_I] * 3, ctypes.c_longlong),
    "sstts_gru_grid_blocks": ([_I], _I),
    "sstts_gru_grid_threads": ([_I] * 2, _I),
    "sstts_gru_grid_active_blocks": ([_I] * 2, _I),
}

#: The `kind` argument of the C entry points (SSTTS_GRU_* in csrc/gru.cu).
KIND_GENERIC, KIND_H128, KIND_WIDE, KIND_GRID = 0, 1, 2, 4

#: The wide kind's constants (kWideThreads, kMaxCluster, kWideMaxRows and
#: kWideMinSmem in csrc/gru.cu): threads of a block at most, the largest
#: cluster, the most batch rows of a cluster's tile, and the least shared
#: memory a block asks for (past half an SM's: one block an SM).
WIDE_THREADS, MAX_CLUSTER, WIDE_MAX_ROWS, WIDE_MIN_SMEM = 512, 16, 8, 118784

#: kWideClusters: clusters of C blocks, one block an SM, that an H100 SXM
#: holds at once (index C; `chip_smoke.py` holds the card to it).
WIDE_CLUSTERS = (0, 132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)

#: The batch the wide kind's cluster size is chosen for: the model's (a
#: training batch and a synthesis batch at the default `Config()`).
WIDE_BATCH = 32

#: The most units a rank of the wide kind owns where a cluster of up to 16
#: allows it: a warp of units.  Clusters of fewer, larger ranks ran slower
#: in both directions at H = 138, 200, 256 and 384 (`tools/ablate_wide.py`
#: on an H100 SXM, PERF.md: 256 on 8 ranks of 32 units 1.99 / 1.53 ms
#: forward / backward, on 4 of 64 units 2.26 / 1.75).
WIDE_UNITS = 32

#: The grid kind's constants (kGridBlocks, kGridThreads, kGridRows and
#: kGridStages in csrc/gru.cu): at most one block per SM of the H100 (132),
#: threads a block, batch rows of a tile, stages of the K tiles' ring.
GRID_BLOCKS, GRID_THREADS, GRID_ROWS, GRID_STAGES = 132, 512, 32, 3

#: kGridStreamStages, kGridStreamQuads and kGridGateItems: the ring's
#: stages and a K tile's float4 quads where the slice streams, and the most
#: (row, unit) gate items a thread takes.
GRID_STREAM_STAGES, GRID_STREAM_QUADS, GRID_GATE_ITEMS = 3, 16, 3

#: The widest H the kernels take (kGridMaxHidden: 42 units a grid block).
MAX_HIDDEN = 5456

#: kGridL2Bytes, the H100's L2: past it the streamed tiles move as bulk
#: copies.
GRID_L2_BYTES = 52428800


def generic_smem_bytes(hidden: int) -> Tuple[int, int]:
    """Shared memory of the generic forward and backward recurrences at
    width H, as `sstts_gru_smem_bytes` and `sstts_gru_bwd_smem_bytes` in
    csrc/gru.cu count it: Wh and the step's vectors, f32."""
    return (3 * hidden * hidden + 7 * hidden) * 4, (3 * hidden * hidden + 8 * hidden) * 4


def _ld(k: int) -> int:
    return k if k % 8 == 4 else k + 4


def wide_shape(hidden: int, cluster: int, rows: int, backward: bool) -> dict:
    """csrc/gru.cu's WideShape: the wide kind's split of width H over a
    cluster of C blocks running a tile of `rows` batch rows.  Rank c owns U
    = ceil(H / C) units and keeps their 3U gate columns of Wh: forward, as
    N = 3U slice rows of KA floats (K = H, the carry's columns, padded to a
    multiple of 4), each thread taking a unit's three gates for every row
    of the tile over one of KS slices of K (the most, up to WIDE_THREADS /
    U and the quads of K, whose partial sums (KS, rows, N) fit beside the
    slice and the tile's carry (2, rows, KA)); backward, untransposed, as N
    = 2 NG slice rows (NG = ceil(H / 2): Wh's rows) of K = 3U columns, each
    thread taking two rows over all of K (KS = 1), beside the step's dgh of
    the rank's columns (rows, KA) and the ranks' partial dh_prev (2, C,
    rows, U).  Slice rows ldw floats apart (4 mod 8); `floats` the block's
    shared memory in floats, `smem` in bytes (at least WIDE_MIN_SMEM);
    threads a block (the product's or the gate pass's rows U, to a warp)."""
    return dict(_wide_shape_of(hidden, cluster, rows, bool(backward)))


@functools.lru_cache(maxsize=None)
def _wide_shape_of(hidden: int, cluster: int, rows: int, backward: bool) -> dict:
    units = -(-hidden // cluster)
    ng = -(-hidden // 2) if backward else units
    n = 2 * ng if backward else 3 * units
    ka = -(-(3 * units if backward else hidden) // 4) * 4
    ws = {"C": cluster, "rows": rows, "U": units, "NG": ng, "N": n, "KA": ka, "ldw": _ld(ka)}

    def floats(k_slices: int) -> int:
        if backward:
            return n * ws["ldw"] + rows * ka + 2 * cluster * rows * units
        return n * ws["ldw"] + 2 * rows * ka + k_slices * rows * n

    k_slices = 1
    while (not backward and k_slices < WIDE_THREADS // units and k_slices < ka // 4
           and floats(k_slices + 1) * 4 <= build.MAX_SMEM):
        k_slices += 1
    prod = ng if backward else units * k_slices
    ws.update(KS=k_slices, floats=floats(k_slices),
              smem=max(floats(k_slices) * 4, WIDE_MIN_SMEM),
              threads=-(-max(prod, rows * units) // 32) * 32)
    ws["valid"] = (2 <= cluster <= MAX_CLUSTER and 1 <= rows <= WIDE_MAX_ROWS
                   and ws["threads"] <= WIDE_THREADS and ws["floats"] * 4 <= build.MAX_SMEM)
    return ws


def wide_rows(hidden: int, batch: int, cluster: int) -> int:
    """The batch rows of a wide cluster's tile at (H, B) on clusters of C,
    as `sstts_gru_wide_rows` counts them: ceil(B / WIDE_CLUSTERS[C]), so
    that the batch runs in one wave of the clusters the card holds, at most
    WIDE_MAX_ROWS, fewer where the forward's or the backward's block would
    not fit (`wide_shape`); 0 where not one row fits."""
    if not 2 <= cluster <= MAX_CLUSTER or batch < 1:
        return 0
    rows = min(-(-batch // WIDE_CLUSTERS[cluster]), WIDE_MAX_ROWS)
    for rows in range(rows, 0, -1):
        if all(wide_shape(hidden, cluster, rows, b)["valid"] for b in (False, True)):
            return rows
    return 0


def wide_smem_bytes(hidden: int, cluster: int, rows: int) -> Tuple[int, int]:
    """Shared memory of one block of the wide forward and backward at width
    H in a cluster of C for a tile of `rows` batch rows, as
    `sstts_gru_wide_smem_bytes` counts it (`wide_shape`)."""
    return tuple(wide_shape(hidden, cluster, rows, b)["smem"] for b in (False, True))


def _grid_smem(gs: dict) -> int:
    """The block's shared memory: the slice's K range [0, R), N rows of
    ldw floats, the ring (where R < KA, GRID_STREAM_STAGES stages that
    also carry the slice's rows) or the K slices' sums, whichever is
    larger, and where R < KA an mbarrier (8 bytes) a stage."""
    streamed = gs["R"] < gs["KA"]
    stages = GRID_STREAM_STAGES if streamed else GRID_STAGES
    stage = GRID_ROWS + (gs["N"] if streamed else 0)
    ring = max(stages * stage * gs["ldt"], gs["KS"] * GRID_ROWS * gs["N"])
    return (gs["N"] * _ld(gs["R"]) + ring + (2 * stages if streamed else 0)) * 4


def _grid_tiles(hidden: int, backward: bool, target: int) -> dict:
    units = -(-hidden // GRID_BLOCKS)
    blocks = -(-hidden // units)
    k = blocks * (3 * units if backward else units)
    n = 3 * -(-units // 3) if backward else 3 * units
    items = GRID_ROWS // 4 * (n // 3)
    k_slices = GRID_THREADS // items if items <= GRID_THREADS else 0
    quads = -(-target // k_slices) if k_slices else 1
    kt = 4 * max(k_slices, 1) * quads
    ka = -(-k // kt) * kt
    prod = -(-items * k_slices // 32) * 32
    gs = {"U": units, "NB": blocks, "N": n, "NG": n // 3, "items": items, "KS": k_slices,
          "KT": kt, "KA": ka, "R": ka, "ldt": _ld(kt),
          "threads": max(prod, min(GRID_ROWS * units, GRID_THREADS))}
    return gs


def _pack_floats(gs: dict) -> int:
    return gs["S"] // gs["KT"] * gs["N"] * gs["ldt"]


def _finish(gs: dict) -> dict:
    gs["ldw"] = _ld(gs["R"])
    gs["S"] = gs["KA"] - gs["R"]
    gs["bulk"] = gs["S"] > 0 and gs["NB"] * _pack_floats(gs) * 4 > GRID_L2_BYTES
    gs["smem"] = _grid_smem(gs)
    return gs


def grid_shape(hidden: int, backward: bool) -> dict:
    """csrc/gru.cu's GridShape at width H: U units a block and NB blocks
    (U the smallest with NB = ceil(H / U) <= 132); the exchanged row's
    width KA (the forward's carry, NB U; the backward's dgh, NB 3U; padded
    to a multiple of the K tile KT); the block's slice of Wh, N rows (3U
    gate columns forward; U rows of Wh backward, padded to a multiple of 3);
    the product's `items` thread tiles (4 batch rows x 3 slice rows) a row
    tile and KS slices of K, each taking KT / 4 / KS float4 quads of a
    tile, about 32 (forward) or 48 (backward) quads a tile, or fewer (32,
    then 16) where the block's shared memory (`smem`: the slice, and the
    ring of K tiles whose space the K slices' sums take after each product)
    would pass 232,448 bytes.  Where even 16 does not fit, the slice
    streams: K tiles of GRID_STREAM_QUADS quads, each of the ring's
    GRID_STREAM_STAGES stages also holding a tile of the slice's N rows
    (with an mbarrier a stage), and the slice's K range [0, R) in shared
    memory, R the most whole tiles that fit beside that ring (R < KA); S =
    KA - R columns of each row streamed from the packed copy, a tile as one
    bulk copy where all blocks' packed tiles pass L2 (`bulk`, from H =
    2377), else as 16-byte copies.  The rows' strides ldw and ldt; threads
    a block (the product's, or the gate pass's 32 U up to 512).  A copy of
    the rule's, cached a width."""
    return dict(_grid_shape_of(hidden, bool(backward)))


@functools.lru_cache(maxsize=None)
def _grid_shape_of(hidden: int, backward: bool) -> dict:
    for target in ((48, 32, 16) if backward else (32, 16)):
        gs = _finish(_grid_tiles(hidden, backward, target))
        if gs["smem"] <= build.MAX_SMEM:
            return gs
    gs = _grid_tiles(hidden, backward, GRID_STREAM_QUADS)
    gs["R"] = 0
    while (gs["R"] + gs["KT"] < gs["KA"]
           and _grid_smem(dict(gs, R=gs["R"] + gs["KT"])) <= build.MAX_SMEM):
        gs["R"] += gs["KT"]
    return _finish(gs)


def grid_smem_bytes(hidden: int) -> Tuple[int, int]:
    """Shared memory of one block of the grid kind's forward and backward
    at width H, as `sstts_gru_grid_smem_bytes` counts it (`grid_shape`)."""
    return tuple(grid_shape(hidden, backward)["smem"] for backward in (False, True))


def grid_exchange_floats(batch: int, hidden: int, backward: bool) -> int:
    """The grid kind's exchange buffer at (B, H), as
    `sstts_gru_grid_exchange_floats` counts it: (2, Bp, KA), Bp = B rounded
    up to 32 rows, and for the backward the carry gradient's direct part
    (Bp, NB U)."""
    gs = grid_shape(hidden, backward)
    rows = -(-batch // GRID_ROWS) * GRID_ROWS
    return rows * (2 * gs["KA"] + (gs["NB"] * gs["U"] if backward else 0))


def grid_pack_floats(hidden: int, backward: bool) -> int:
    """Floats of one block's packed K range [R, KA) (`GridShape::
    pack_floats`): its S / KT streamed K tiles, each N rows of ldt floats,
    as the ring holds them."""
    return _pack_floats(grid_shape(hidden, backward))


def grid_scratch_floats(batch: int, hidden: int, backward: bool) -> int:
    """The grid kind's scratch at (B, H), as `sstts_gru_grid_scratch_floats`
    counts it: the exchange buffer, then the packed K range [R, KA) of every
    block's slice, NB `grid_pack_floats`."""
    gs = grid_shape(hidden, backward)
    return (grid_exchange_floats(batch, hidden, backward)
            + gs["NB"] * grid_pack_floats(hidden, backward))


def _grid_fits(hidden: int) -> bool:
    """GridShape::valid: one gate item a thread where the slice is resident,
    at most GRID_GATE_ITEMS where it streams; KS, threads, blocks and shared
    memory within the block's."""
    return all(gs["KS"] >= 1
               and GRID_ROWS * gs["U"] <= (GRID_GATE_ITEMS if gs["S"] else 1) * gs["threads"]
               and gs["threads"] <= GRID_THREADS and gs["NB"] <= GRID_BLOCKS
               and gs["smem"] <= build.MAX_SMEM
               for gs in (grid_shape(hidden, bwd) for bwd in (False, True)))


def _wide_cluster(hidden: int) -> Optional[int]:
    """The smallest cluster of at most WIDE_UNITS units a rank (where 16
    ranks allow it) whose tile takes WIDE_BATCH in one wave of the
    clusters the card holds (`wide_rows` gives its full ceil(32 /
    WIDE_CLUSTERS[C]) rows), or None."""
    for cluster in range(min(MAX_CLUSTER, max(2, -(-hidden // WIDE_UNITS))), MAX_CLUSTER + 1):
        rows = -(-WIDE_BATCH // WIDE_CLUSTERS[cluster])
        if rows <= WIDE_MAX_ROWS and wide_rows(hidden, WIDE_BATCH, cluster) == rows:
            return cluster
    return None


def _config(hidden: int) -> Optional[Tuple[int, int]]:
    if hidden == 128:
        return KIND_H128, 1
    if max(generic_smem_bytes(hidden)) <= build.MAX_SMEM:
        return KIND_GENERIC, 1
    cluster = _wide_cluster(hidden)
    if cluster is not None:
        return KIND_WIDE, cluster
    if hidden <= MAX_HIDDEN and _grid_fits(hidden):
        return KIND_GRID, grid_shape(hidden, False)["NB"]
    return None


#: The first width that no cluster takes in one wave, where the grid kind
#: starts.
GRID_MIN_HIDDEN = next(h for h in range(138, MAX_HIDDEN) if _wide_cluster(h) is None)


def kernel_config(hidden: int) -> Tuple[int, int]:
    """(kind, cluster size or blocks) of the CUDA recurrences at width H:
    the register-resident kernels at H = 128, the generic ones where their
    block fits (H up to 137), the wide ones on the smallest cluster of at
    most 32 units a rank (where 16 ranks allow it) whose block holds the
    tile B = 32 needs for one wave (up to 522; the tile's
    rows at other batches: `wide_rows`), else the grid kind on NB =
    ceil(H / U) blocks,
    U = ceil(H / 132), up to MAX_HIDDEN = 5456 (`grid_shape`: past 1419 a
    block streams the part of its slice that its shared memory cannot
    hold).  NotImplementedError past MAX_HIDDEN.  A pure function of H:
    nothing is built or launched; the grid's residency on the card is
    checked at each launch."""
    config = _config(hidden)
    if config is None:
        raise NotImplementedError(
            f"the gru_sequence CUDA kernels take H up to MAX_HIDDEN = {MAX_HIDDEN}, "
            f"{-(-MAX_HIDDEN // GRID_BLOCKS)} units a block of the grid kind; "
            f"this GRU has H={hidden}"
        )
    return config


def check_width(hidden: int, device) -> None:
    """`kernel_config` on the card, where it raises NotImplementedError for
    H > MAX_HIDDEN; the plain versions on the CPU take any H."""
    if torch.device(device).type == "cuda":
        kernel_config(hidden)


def check_arch(arch, device) -> None:
    """`check_width` for each of `arch`'s sequence GRUs (the two CBHGs')."""
    for hidden in (arch.encoder_gru_units, arch.post_gru_units):
        check_width(hidden, device)


def gru_step_math(x, h, wx, wh, b):
    """Fused-gate GRU step; the candidate uses the r * (h @ U_n) form."""
    hidden = h.shape[-1]
    gx = x @ wx + b
    gh = h @ wh
    xr, xz, xn = gx[..., :hidden], gx[..., hidden : 2 * hidden], gx[..., 2 * hidden :]
    hr, hz, hn = gh[..., :hidden], gh[..., hidden : 2 * hidden], gh[..., 2 * hidden :]
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return z * h + (1.0 - z) * n


def _steps(t_len: int, reverse: bool):
    return range(t_len - 1, -1, -1) if reverse else range(t_len)


def gru_sequence_forward_plain(
    xs: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step loop with the kernel's semantics (any device; f32).  Returns
    (out (B, T, H), gates (B, T, 4H) = [r, z, n, hn], hprev (B, T, H) = the
    carry before each step): what the kernel writes when a gradient is
    wanted."""
    batch, t_len, _ = xs.shape
    hidden = wh.shape[0]
    xs = xs.float()
    m = None if mask is None else mask.float()
    h = xs.new_zeros(batch, hidden)
    ys, gates, hprev = [None] * t_len, [None] * t_len, [None] * t_len
    gx_all = xs @ wx + b
    for t in _steps(t_len, reverse):
        gx, gh = gx_all[:, t], h @ wh
        r = torch.sigmoid(gx[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(gx[:, hidden : 2 * hidden] + gh[:, hidden : 2 * hidden])
        hn = gh[:, 2 * hidden :]
        n = torch.tanh(gx[:, 2 * hidden :] + r * hn)
        gates[t] = torch.cat([r, z, n, hn], -1)
        hprev[t] = h
        h_new = z * h + (1.0 - z) * n
        if m is not None:
            mt = m[:, t, None]
            h_new = mt * h_new + (1.0 - mt) * h
            ys[t] = mt * h_new
        else:
            ys[t] = h_new
        h = h_new
    return torch.stack(ys, 1), torch.stack(gates, 1), torch.stack(hprev, 1)


def gru_sequence_plain(
    xs: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """(B, T, D) -> (B, T, H): the forward's outputs only."""
    return gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)[0]


def gru_sequence_backward_plain(
    dout: torch.Tensor,
    gates: torch.Tensor,
    hprev: torch.Tensor,
    wh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function as an explicit reverse loop (not
    autograd): from the output gradient (B, T, H) and the forward's saved
    gates/hprev, the gate-preactivation gradients dgx and dgh (B, T, 3H),
    dgh being dgx with the candidate's entry times r."""
    batch, t_len, hidden = dout.shape
    dout = dout.float()
    m = None if mask is None else mask.float()
    dh = dout.new_zeros(batch, hidden)
    dgx, dgh = [None] * t_len, [None] * t_len
    for t in _steps(t_len, not reverse):
        g = gates[:, t]
        r, z = g[:, :hidden], g[:, hidden : 2 * hidden]
        n, hn = g[:, 2 * hidden : 3 * hidden], g[:, 3 * hidden :]
        mt = 1.0 if m is None else m[:, t, None]
        dh_t = dh + mt * dout[:, t]
        dh_new = mt * dh_t
        dz = dh_new * (hprev[:, t] - n)
        dan = dh_new * (1.0 - z) * (1.0 - n * n)
        dar = dan * hn * r * (1.0 - r)
        daz = dz * z * (1.0 - z)
        dgx[t] = torch.cat([dar, daz, dan], -1)
        dgh[t] = torch.cat([dar, daz, dan * r], -1)
        dh = (1.0 - mt) * dh_t + dh_new * z + dgh[t] @ wh.T
    return torch.stack(dgx, 1), torch.stack(dgh, 1)


def _check_shapes(xs, wx, wh, b, mask) -> None:
    if xs.dim() != 3 or wh.dim() != 2:
        raise ValueError(
            f"gru_sequence: xs {tuple(xs.shape)} must be (B, T, D) and wh "
            f"{tuple(wh.shape)} (H, 3H)"
        )
    d_in, hidden = xs.shape[-1], wh.shape[0]
    if tuple(wx.shape) != (d_in, 3 * hidden) or tuple(wh.shape) != (
        hidden, 3 * hidden
    ) or tuple(b.shape) != (3 * hidden,):
        raise ValueError(
            f"gru_sequence: shapes xs {tuple(xs.shape)}, wx {tuple(wx.shape)},"
            f" wh {tuple(wh.shape)}, b {tuple(b.shape)} do not agree"
        )
    _check_mask(mask, xs.shape[:2], "gru_sequence")


def _check_mask(mask, batch_time, what: str) -> None:
    if mask is not None and tuple(mask.shape) != tuple(batch_time):
        raise ValueError(
            f"{what}: mask {tuple(mask.shape)} must be (B, T) = {tuple(batch_time)}"
        )


def _load(hidden: int):
    """The library and the (kind, cluster size) of kernel for width H."""
    return build.load("gru", SIGNATURES), kernel_config(hidden)


def _scratch(batch: int, hidden: int, kind: int, dev, backward: bool) -> Optional[torch.Tensor]:
    """A launch's scratch: the grid kind's exchange buffer, zeroed, and the
    room for its packed copy (`grid_scratch_floats`); else None."""
    if kind != KIND_GRID:
        return None
    scratch = torch.empty(grid_scratch_floats(batch, hidden, backward), device=dev,
                          dtype=torch.float32)
    scratch[: grid_exchange_floats(batch, hidden, backward)].zero_()
    return scratch


def _mask_f32(mask, dev):
    return None if mask is None else mask.to(dev, torch.float32).contiguous()


def _dense(t):
    """f32, contiguous and 16-byte aligned (the kernels read float4)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel(xs, wx, wh, b, mask, reverse, save: bool):
    batch, t_len, d_in = xs.shape
    hidden = wh.shape[0]
    lib, (kind, cluster) = _load(hidden)
    dev = xs.device
    f32 = dict(device=dev, dtype=torch.float32)
    xs_c, wx_c, wh_c, b_c = (_dense(a) for a in (xs, wx, wh, b))
    m_c = _mask_f32(mask, dev)
    gx = torch.empty(batch, t_len, 3 * hidden, **f32)
    out = torch.empty(batch, t_len, hidden, **f32)
    gates = torch.empty(batch, t_len, 4 * hidden, **f32) if save else None
    hprev = torch.empty(batch, t_len, hidden, **f32) if save else None
    scratch = _scratch(batch, hidden, kind, dev, backward=False)
    rc = lib.sstts_gru_sequence(
        xs_c.data_ptr(), wx_c.data_ptr(), wh_c.data_ptr(), b_c.data_ptr(),
        _ptr(m_c), gx.data_ptr(), out.data_ptr(), _ptr(gates), _ptr(hprev), _ptr(scratch),
        batch, t_len, d_in, hidden, int(bool(reverse)), kind, cluster,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "gru_sequence")
    gru_sequence.launches += 1
    return out, gates, hprev


def gru_sequence_backward(
    dout: torch.Tensor,
    gates: torch.Tensor,
    hprev: torch.Tensor,
    wh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward recurrence: (dgx, dgh), each (B, T, 3H) f32.  CPU
    tensors run `gru_sequence_backward_plain`; CUDA tensors launch the
    kernel (counted in `gru_sequence_backward.launches`)."""
    batch, t_len, hidden = dout.shape
    _check_mask(mask, (batch, t_len), "gru_sequence_backward")
    if dout.device.type == "cpu":
        return gru_sequence_backward_plain(dout, gates, hprev, wh, mask, reverse)
    if dout.device.type != "cuda":
        raise NotImplementedError(f"gru_sequence_backward on {dout.device.type}")
    if tuple(gates.shape) != (batch, t_len, 4 * hidden) or tuple(hprev.shape) != (
        batch, t_len, hidden
    ) or tuple(wh.shape) != (hidden, 3 * hidden):
        raise ValueError(
            f"gru_sequence_backward: shapes dout {tuple(dout.shape)}, gates "
            f"{tuple(gates.shape)}, hprev {tuple(hprev.shape)}, wh {tuple(wh.shape)}"
        )
    lib, (kind, cluster) = _load(hidden)
    dev = dout.device
    dout_c, gates_c, hprev_c, wh_c = (_dense(a) for a in (dout, gates, hprev, wh))
    m_c = _mask_f32(mask, dev)
    dgx = torch.empty(batch, t_len, 3 * hidden, device=dev, dtype=torch.float32)
    dgh = torch.empty_like(dgx)
    scratch = _scratch(batch, hidden, kind, dev, backward=True)
    rc = lib.sstts_gru_sequence_backward(
        dout_c.data_ptr(), gates_c.data_ptr(), hprev_c.data_ptr(),
        wh_c.data_ptr(), _ptr(m_c), dgx.data_ptr(), dgh.data_ptr(), _ptr(scratch),
        batch, t_len, hidden, int(bool(reverse)), kind, cluster,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "gru_sequence_backward")
    gru_sequence_backward.launches += 1
    return dgx, dgh


gru_sequence_backward.launches = 0


def _forward(xs, wx, wh, b, mask, reverse, save: bool):
    _check_shapes(xs, wx, wh, b, mask)
    if xs.device.type == "cpu":
        if not save:
            return gru_sequence_plain(xs, wx, wh, b, mask, reverse), None, None
        return gru_sequence_forward_plain(xs, wx, wh, b, mask, reverse)
    if xs.device.type != "cuda":
        raise NotImplementedError(f"gru_sequence on {xs.device.type}")
    return _kernel(xs, wx, wh, b, mask, reverse, save)


class _GRUSequence(torch.autograd.Function):
    """Kernel (or plain) forward that keeps the gates; backward recurrence
    by `gru_sequence_backward`, products by torch.matmul."""

    @staticmethod
    def forward(ctx, xs, wx, wh, b, mask, reverse):
        out, gates, hprev = _forward(xs, wx, wh, b, mask, reverse, save=True)
        ctx.save_for_backward(xs, wx, wh, mask, gates, hprev)
        ctx.reverse = reverse
        return out

    @staticmethod
    def backward(ctx, dout):
        xs, wx, wh, mask, gates, hprev = ctx.saved_tensors
        dgx, dgh = gru_sequence_backward(dout, gates, hprev, wh, mask, ctx.reverse)
        d_in, g3 = wx.shape
        dxs = dgx @ wx.float().T
        dwx = xs.float().reshape(-1, d_in).T @ dgx.reshape(-1, g3)
        dwh = hprev.reshape(-1, wh.shape[0]).T @ dgh.reshape(-1, g3)
        db = dgx.sum((0, 1))
        return dxs, dwx, dwh, db, None, None


def gru_sequence(
    xs: torch.Tensor,
    wx: torch.Tensor,
    wh: torch.Tensor,
    b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    reverse: bool = False,
) -> torch.Tensor:
    """(B, T, D) inputs -> (B, T, H) GRU outputs (f32), differentiable.

    CPU tensors run the plain versions; CUDA tensors launch the kernels
    (each forward launch counted in `gru_sequence.launches`).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xs, wx, wh, b)):
        return _GRUSequence.apply(xs, wx, wh, b, mask, reverse)
    return _forward(xs, wx, wh, b, mask, reverse, save=False)[0]


gru_sequence.launches = 0
