"""Fused autoregressive decode: the port of `sstts/ops/pallas_decoder.py`
`fused_decode` (59-352), kernel B4.

`fused_decode` hoists the per-utterance key projection (as JAX does), casts
the cell's weights to the matmul dtype, and hands a `DecodeInputs` to
`decode_steps`, which dispatches on the device: a CPU tensor runs
`decode_steps_plain` (the kernel's math in plain torch), a CUDA tensor
launches `sstts_torch/csrc/decoder.cu` or raises.

The kernel reads the cell's matrices as one stream: on the card,
`prepare_decode` packs the twelve into one buffer in the order a step reads
them, each row padded to 16 bytes (`pack_weights`), and `chunk_schedule`
cuts that buffer, with each utterance's keys and memory where the attention
reads them, into chunks of whole rows of at most one ring stage, copied to
the card without waiting for it.  A product wider than MAX_COLS columns is
packed, and streamed, as column panels of at most MAX_COLS (`panels`): each
panel's rows lie together and run through the stream as their own run of
chunks, which carry the panel's first column; memory wider than MAX_COLS
is laid out in panels too (`memory_panels`).  The kernel's producer walks
that schedule once a step; `decode_steps_plain` reads the unpacked weights.

Dropout follows the reference kernel's contract
(`sstts/ops/pallas_decoder.py:156-166, 231-239`): one int32 `seed` a
decode, step t draws from `seed + t` (wrapping as int32), a unit is kept
where its uint32 bits are `>= keep_threshold(rate)` and scaled by
1 / (1 - rate), and rate >= 1 gives zeros.  The bits are `keep_bits`, a
stateless counter-based generator (Philox4x32-10) of (seed + t, global row,
prenet layer, unit) that the kernel computes in place and the plain
versions (`decode_steps_plain`, `Tacotron.decode_infer` through
`keep_masks`) compute in int64 tensor ops, so the three agree bit for bit
at one seed.  `row0` is the first global row of a batch, so that a shard
of a batch draws the global batch's rows.  JAX's kernel draws its bits on
the TPU core, a stream no other device reproduces, so parity with JAX runs
with dropout off.  Products take both operands rounded to the matmul dtype
(bf16 by default, or f32) with f32 accumulation; gates and softmax run in
f32.

`decode_route` is the reference's per-shape gate
(`sstts/synthesize.py:281-296`): a batch whose T is past the kernel's reach
(`text_reach`, the library's own count of shared memory, once per widths
and device) takes the plain loop, decided from the shape before any launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from sstts_torch.ops import build, require_no_grad

#: Weight matrices, each (K, N) row-major, in the order a step reads them
#: (and `pack_weights` lays them out); the vectors (biases, score v) stay f32.
_MATRICES = (
    "prenet_w0", "prenet_w1", "attn_wx", "attn_wh", "query_w", "dec_w",
    "gru0_wx", "gru0_wh", "gru1_wx", "gru1_wh", "frame_w", "stop_w",
)


class DecoderWeights(NamedTuple):
    prenet_w0: torch.Tensor  # (M, P0)
    prenet_b0: torch.Tensor
    prenet_w1: torch.Tensor  # (P0, P1)
    prenet_b1: torch.Tensor
    attn_wx: torch.Tensor  # (P1 + Dm, 3 Ha)
    attn_wh: torch.Tensor  # (Ha, 3 Ha)
    attn_b: torch.Tensor
    query_w: torch.Tensor  # (Ha, A)
    score_v: torch.Tensor
    score_b: torch.Tensor
    dec_w: torch.Tensor  # (Ha + Dm, Hd)
    dec_b: torch.Tensor
    gru0_wx: torch.Tensor  # (Hd, 3 Hd)
    gru0_wh: torch.Tensor
    gru0_b: torch.Tensor
    gru1_wx: torch.Tensor
    gru1_wh: torch.Tensor
    gru1_b: torch.Tensor
    frame_w: torch.Tensor  # (Hd, r M)
    frame_b: torch.Tensor
    stop_w: torch.Tensor  # (Hd, r)
    stop_b: torch.Tensor


#: Bytes of one of the kernel's ring stages (kStageBytes in
#: csrc/chain.cuh, B4's and B6's): the schedule's chunks are cut to it.
STAGE_BYTES = 65536

#: Sources a chunk is copied from: the packed weights, or this utterance's
#: rows of keys or of memory.
SRC_WEIGHTS, SRC_KEYS, SRC_MEMORY = 0, 1, 2

#: The products of one step in the order the kernel reads their operands.
STEP_ORDER = (
    "prenet_w0", "prenet_w1", "attn_wx", "attn_wh", "query_w", "keys", "memory",
    "dec_w", "gru0_wx", "gru0_wh", "gru1_wx", "gru1_wh", "frame_w", "stop_w",
)

#: Widest column panel of a product (a consumer thread holds one 16-byte
#: segment of a panel's row: 256 of them a 1024-column f32 row; kMaxCols in
#: csrc/chain.cuh).  Wider products are cut into panels (`panels`).
MAX_COLS = 1024

#: Columns of a schedule row (int32): source, product (index in STEP_ORDER),
#: byte offset in the source, bytes, first and end row (k), row bytes, and
#: the first column of the product's panel the rows belong to.
CHUNK_FIELDS = ("src", "product", "offset", "bytes", "k0", "k1", "row_bytes", "col0")


class Product(NamedTuple):
    """One operand of a step's stream, or one column panel of it: `rows` (K)
    rows of `cols` (N) values, `row_bytes` apart, from `offset` bytes into
    its source; the panel's first column is `col0` of the whole product."""

    name: str
    src: int
    offset: int
    rows: int
    cols: int
    row_bytes: int
    col0: int = 0


def panels(cols: int) -> Tuple[Tuple[int, int], ...]:
    """The column panels of a product `cols` wide, (first column, width):
    MAX_COLS columns each, the last the rest."""
    return tuple((c0, min(MAX_COLS, cols - c0)) for c0 in range(0, cols, MAX_COLS))


def row_bytes(cols: int, itemsize: int) -> int:
    """Bytes of one row of `cols` values, padded to a multiple of 16."""
    return -(-cols * itemsize // 16) * 16


def weight_layout(w, names=_MATRICES, dtype: Optional[torch.dtype] = None
                  ) -> Tuple[Product, ...]:
    """Where each matrix of `names` (fields of `w`, each (K, N)) lies in the
    packed buffer, in that order: B4's twelve by default, B6's eight
    (`sstts_torch.ops.teacher.MATRICES`); a matrix wider than MAX_COLS as
    its column panels, one after the other, each (K, width) with its own
    rows.  Rows are of `dtype` (the matrices' own by default)."""
    out, offset = [], 0
    for name in names:
        m = getattr(w, name)
        k, n = m.shape
        size = dtype.itemsize if dtype is not None else m.element_size()
        for col0, cols in panels(n):
            rb = row_bytes(cols, size)
            out.append(Product(name, SRC_WEIGHTS, offset, k, cols, rb, col0))
            offset += k * rb
    return tuple(out)


def pack_weights(w, names=_MATRICES, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The matrices of `names` as one contiguous byte buffer on their
    device, laid out by `weight_layout`, cast to `dtype` (the matrices' own
    by default) as they are copied in: one copy a matrix.  The padding of
    each row is zeros."""
    dtype = dtype or getattr(w, names[0]).dtype
    layout = weight_layout(w, names, dtype)
    end = layout[-1].offset + layout[-1].rows * layout[-1].row_bytes
    padded = any(pr.row_bytes != pr.cols * dtype.itemsize for pr in layout)
    buf = (torch.zeros if padded else torch.empty)(
        end, dtype=torch.uint8, device=getattr(w, names[0]).device)
    for pr in layout:
        rows = buf[pr.offset : pr.offset + pr.rows * pr.row_bytes].view(dtype)
        m = getattr(w, pr.name)
        rows.view(pr.rows, -1)[:, : pr.cols].copy_(m[:, pr.col0 : pr.col0 + pr.cols])
    return buf


def memory_panels(memory: torch.Tensor) -> torch.Tensor:
    """Memory (B, T, Dm) as the kernels read it: rows padded to 16 bytes
    (`_rows16`) and, wider than MAX_COLS, one (B * T, width) block a column
    panel (`panels`), the blocks one after the other."""
    cut = panels(memory.shape[-1])
    if len(cut) == 1:
        return _rows16(memory)
    return torch.cat([_rows16(memory[..., c0 : c0 + n].contiguous()).reshape(-1)
                      for c0, n in cut])


def step_products(layout, T: int, A: int, Dm: int, itemsize: int, order,
                  batch: int) -> Tuple[Product, ...]:
    """A step's operands in `order` (B4's `STEP_ORDER` or B6's
    `sstts_torch.ops.teacher.STEP_ORDER`), each as its column panels: the
    packed matrices, with this utterance's keys (T, A), whole rows, and
    memory (T, Dm) where the attention reads them.  A memory panel's offset
    is that of its block in `memory_panels` of `batch` utterances (the
    kernel adds the utterance's first row)."""
    by_name = {}
    for pr in layout:
        by_name.setdefault(pr.name, []).append(pr)
    by_name["keys"] = [Product("keys", SRC_KEYS, 0, T, A, row_bytes(A, itemsize))]
    mem, offset = [], 0
    for col0, cols in panels(Dm):
        rb = row_bytes(cols, itemsize)
        mem.append(Product("memory", SRC_MEMORY, offset, T, cols, rb, col0))
        offset += batch * T * rb
    by_name["memory"] = mem
    return tuple(pr for name in order for pr in by_name[name])


def chunk_schedule(products, stage_bytes: int = STAGE_BYTES) -> torch.Tensor:
    """The chunks of one step, (n, 8) int32 (`CHUNK_FIELDS`): each product,
    panel by panel, cut into runs of whole rows of at most `stage_bytes`, in
    step order; a chunk's `product` counts the step's operands (a product's
    panels share it)."""
    rows, pid = [], -1
    for i, pr in enumerate(products):
        if i == 0 or pr.name != products[i - 1].name:
            pid += 1
        per = stage_bytes // pr.row_bytes
        if per < 1:
            raise NotImplementedError(
                f"fused decode: a row of {pr.name} is {pr.row_bytes} bytes, more "
                f"than one {stage_bytes}-byte ring stage"
            )
        for k0 in range(0, pr.rows, per):
            k1 = min(pr.rows, k0 + per)
            rows.append((pr.src, pid, pr.offset + k0 * pr.row_bytes,
                         (k1 - k0) * pr.row_bytes, k0, k1, pr.row_bytes, pr.col0))
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, len(CHUNK_FIELDS))


class DecodeInputs(NamedTuple):
    """Everything one fused decode reads, already on its device."""

    w: DecoderWeights
    memory: torch.Tensor  # (B, T, Dm) matmul dtype
    keys: torch.Tensor  # (B, T, A) matmul dtype
    maskf: torch.Tensor  # (B, T) f32 {0, 1}
    seed: Optional[int]  # the prenet dropout's int32 seed, or None (no dropout)
    row0: int  # the global row of this batch's first row
    rate: float  # the prenet dropout rate
    max_steps: int
    n_mels: int
    reduction: int
    stop_threshold: float
    min_steps: int
    # On the card only (None on the CPU, whose plain version reads `w`):
    packed: Optional[torch.Tensor]  # the twelve matrices, `pack_weights`
    schedule: Optional[torch.Tensor]  # one step's chunks, `chunk_schedule`


def supports_arch(arch) -> bool:
    """The kernel implements Bahdanau attention, a 2-layer prenet and
    exactly 2 residual decoder GRUs."""
    return (
        arch.attention_type == "bahdanau"
        and arch.decoder_gru_layers == 2
        and len(arch.prenet_units) == 2
    )


def resolve_decoder_impl(override, arch, device) -> str:
    """"xla" (the plain module loop, `Tacotron.decode_infer`) or "fused"
    (`fused_decode`) for `inference.decoder_impl` in (None, "auto", "xla",
    "fused") on `device`, by the reference's rule
    (`sstts/synthesize.py:245-268`): "auto" is the kernel on CUDA where it
    implements the architecture (`supports_arch`), else the plain loop;
    "fused" on an architecture it lacks raises ValueError.  The kernel
    takes products of any width (in column panels).  A pure function of its
    arguments: nothing is launched."""
    impl = override or "auto"
    if impl not in ("auto", "xla", "fused"):
        raise ValueError(f"unknown decoder_impl {impl!r}; expected 'auto', 'xla', 'fused'")
    if impl == "fused" and not supports_arch(arch):
        raise ValueError(
            "decoder_impl='fused' implements only Bahdanau attention "
            "with a 2-layer prenet and 2 decoder GRUs; this config "
            "needs the XLA scan"
        )
    cuda = torch.device(device).type == "cuda"
    if impl == "auto":
        impl = "fused" if cuda and supports_arch(arch) else "xla"
    return impl


def weights_from_cell(cell, matmul_dtype: torch.dtype) -> DecoderWeights:
    """The decoder cell's parameters in kernel layout: Linear weights
    transposed to (in, out), matrices in the matmul dtype, vectors f32."""
    if not supports_arch(cell.arch):
        raise NotImplementedError(
            "the fused decoder implements Bahdanau attention with a 2-layer "
            "prenet and 2 decoder GRUs; this architecture is not supported"
        )
    lin = lambda m: (m.weight.T, m.bias)  # noqa: E731
    w0, b0 = lin(cell.prenet.fc0)
    w1, b1 = lin(cell.prenet.fc1)
    dw, db = lin(cell.dec_proj)
    fw, fb = lin(cell.frame_proj)
    sw, sb = lin(cell.stop_proj)
    g = [cell.attn_gru, cell.dec_gru0, cell.dec_gru1]
    raw = DecoderWeights(
        w0, b0, w1, b1,
        g[0].wx, g[0].wh, g[0].b,
        cell.attention.query_proj.weight.T, cell.attention.v, cell.attention.b,
        dw, db,
        g[1].wx, g[1].wh, g[1].b,
        g[2].wx, g[2].wh, g[2].b,
        fw, fb, sw, sb,
    )
    return DecoderWeights(
        *[
            t.detach().to(matmul_dtype if name in _MATRICES else torch.float32).contiguous()
            for name, t in zip(DecoderWeights._fields, raw)
        ]
    )


# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
# 3", SC 2011): its round multipliers and key increments (Weyl constants).
# csrc/decoder.cu:philox_keep_bits is the kernel's copy.
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * m, for a in [0, 2^32) (int64) and a
    32-bit constant m, from 16-bit halves so that no int64 product
    overflows."""
    al, ah = a & 0xFFFF, a >> 16
    ml, mh = m & 0xFFFF, m >> 16
    ll, lh, hl = al * ml, al * mh, ah * ml
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = (ah * mh + (lh >> 16) + (hl >> 16) + (mid >> 16)) & _U32
    return hi, lo


def philox4x32(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 of four 32-bit counter words and two key words (int64
    tensors or ints in [0, 2^32), broadcast together): its four output
    words, int64 in [0, 2^32)."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for i in range(10):
        if i:
            k0, k1 = (k0 + _PHILOX_W[0]) & _U32, (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_bits(seed: int, steps: int, row0: int, rows: int, layer: int, units: int,
              device=None) -> torch.Tensor:
    """The prenet dropout's uint32 bits, (steps, rows, units) int64 in
    [0, 2^32): for step t, global row row0 + b, prenet `layer` and unit j,
    word 0 of Philox4x32-10 with counter (j, row0 + b, layer, 0) and key
    (seed + t, 0), seed + t wrapping as int32 (the reference seeds step t
    with `seed_ref[0] + t`)."""
    kw = dict(dtype=torch.int64, device=device)
    t = torch.arange(steps, **kw)[:, None, None]
    row = (row0 + torch.arange(rows, **kw))[None, :, None]
    unit = torch.arange(units, **kw)[None, None, :]
    return philox4x32((unit, row, layer, 0), ((seed + t) & _U32, 0))[0]


def keep_threshold(rate: float) -> int:
    """The reference's uint32 keep threshold, `min(rate 2^32, 2^32 - 1)` of
    the rate clamped to [0, 1]: a unit is kept where its bits are >= it."""
    rate = min(max(float(rate), 0.0), 1.0)
    return int(min(rate * 4294967296.0, 4294967295.0))


def dropout_scale(rate: float) -> float:
    """The kept units' scale, 1 / (1 - rate); 0 at rate >= 1, where every
    unit is zeroed."""
    return 1.0 / (1.0 - rate) if rate < 1.0 else 0.0


def keep_masks(seed: Optional[int], row0: int, steps: int, rows: int, units, rate: float,
               device=None) -> Optional[List[torch.Tensor]]:
    """Per-layer keep masks (steps, rows, P) f32 {0, 1} of prenet layers of
    `units` from `keep_bits`, as the kernel keeps them; None without a
    seed or at rate <= 0 (dropout is then the identity)."""
    if seed is None or rate <= 0.0:
        return None
    threshold = keep_threshold(rate)
    return [(keep_bits(seed, steps, row0, rows, i, p, device) >= threshold).float()
            for i, p in enumerate(units)]


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with both operands rounded to w's dtype, f32 accumulation."""
    return x.to(w.dtype).float() @ w.float()


def _gru_step(x, h, wx, wh, b):
    hidden = h.shape[-1]
    gx = _dot(x, wx) + b
    gh = _dot(h, wh)
    r = torch.sigmoid(gx[:, :hidden] + gh[:, :hidden])
    z = torch.sigmoid(gx[:, hidden : 2 * hidden] + gh[:, hidden : 2 * hidden])
    n = torch.tanh(gx[:, 2 * hidden :] + r * gh[:, 2 * hidden :])
    return z * h + (1.0 - z) * n


def decode_steps_plain(p: DecodeInputs) -> Dict[str, torch.Tensor]:
    """The kernel's function in plain torch (any device): mel (B, S, r*M),
    stop (B, S, r), align (B, S, T), fin (B, S) f32 (1 = finished before
    the step)."""
    w = p.w
    B, T, Dm = p.memory.shape
    Ha, Hd = w.attn_wh.shape[0], w.gru0_wh.shape[0]
    r, M = p.reduction, p.n_mels
    dev = p.memory.device
    mem = p.memory.float()
    keys = p.keys.float()
    zeros = lambda n: torch.zeros(B, n, device=dev)  # noqa: E731
    attn_h, h0, h1, ctx, prev = zeros(Ha), zeros(Hd), zeros(Hd), zeros(Dm), zeros(M)
    fin = zeros(1)
    masks = keep_masks(p.seed, p.row0, p.max_steps, B,
                       (w.prenet_w0.shape[1], w.prenet_w1.shape[1]), p.rate, dev)
    scale = dropout_scale(p.rate)
    mels, stops, aligns, fins = [], [], [], []
    for t in range(p.max_steps):
        fin_old = fin
        x = F.relu(_dot(prev, w.prenet_w0) + w.prenet_b0)
        if masks is not None:
            x = torch.where(masks[0][t] > 0, x * scale, torch.zeros_like(x))
        x = F.relu(_dot(x, w.prenet_w1) + w.prenet_b1)
        if masks is not None:
            x = torch.where(masks[1][t] > 0, x * scale, torch.zeros_like(x))
        h_a = _gru_step(torch.cat([x, ctx], -1), attn_h, w.attn_wx, w.attn_wh, w.attn_b)
        q = _dot(h_a, w.query_w) + w.score_b
        s = torch.tanh(keys + q[:, None, :])
        scores = (s * w.score_v).sum(-1)
        scores = torch.where(p.maskf > 0, scores, torch.full_like(scores, -1e9))
        e = torch.exp(scores - scores.max(-1, keepdim=True).values)
        align = e / e.sum(-1, keepdim=True)
        c = torch.einsum("bt,btd->bd", align, mem)
        d = _dot(torch.cat([h_a, c], -1), w.dec_w) + w.dec_b
        n0 = _gru_step(d, h0, w.gru0_wx, w.gru0_wh, w.gru0_b)
        d = d + n0
        n1 = _gru_step(d, h1, w.gru1_wx, w.gru1_wh, w.gru1_b)
        d = d + n1
        mel = _dot(d, w.frame_w) + w.frame_b
        stop = _dot(d, w.stop_w) + w.stop_b
        done = fin_old > 0
        mel = torch.where(done, torch.zeros_like(mel), mel)
        hit = (torch.sigmoid(stop.max(-1, keepdim=True).values) > p.stop_threshold).float()
        if p.min_steps > 0 and t < p.min_steps - 1:
            hit = torch.zeros_like(hit)
        fin = torch.maximum(fin_old, hit)
        keep = lambda new, old: torch.where(done, old, new)  # noqa: E731
        attn_h, h0, h1 = keep(h_a, attn_h), keep(n0, h0), keep(n1, h1)
        ctx = keep(c, ctx)
        prev = keep(mel[:, (r - 1) * M :], prev)
        mels.append(mel)
        stops.append(stop)
        aligns.append(align)
        fins.append(fin_old[:, 0])
    return {
        "mel": torch.stack(mels, 1),
        "stop": torch.stack(stops, 1),
        "align": torch.stack(aligns, 1),
        "fin": torch.stack(fins, 1),
    }


#: The vectors of `DecoderWeights` (biases and the score vector), f32.
_VECTORS = tuple(n for n in DecoderWeights._fields if n not in _MATRICES)


class _DecodeArgs(ctypes.Structure):
    """Mirror of `DecodeArgs` in csrc/decoder.cu (same field order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (
            "packed", "schedule", *_VECTORS, "memory", "keys", "mask",
            "mel", "stop", "align", "fin",
        )
    ] + [
        (name, ctypes.c_int)
        for name in (
            "B", "T", "S", "M", "P0", "P1", "Dm", "A", "Ha", "Hd", "r",
            "min_steps", "n_chunks", "dropout", "row0",
        )
    ] + [("seed", ctypes.c_uint32), ("threshold", ctypes.c_uint32),
         ("stop_threshold", ctypes.c_float), ("dropout_scale", ctypes.c_float)]


_SIGNATURES = {
    "sstts_fused_decode": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "sstts_decode_smem_bytes": ([ctypes.c_void_p], ctypes.c_int),
}


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """`x` with its last dimension padded (zeros) to rows of a multiple of
    16 bytes, on a 16-byte aligned address, as the bulk copies need."""
    cols = x.shape[-1]
    ld = row_bytes(cols, x.element_size()) // x.element_size()
    if ld == cols and x.data_ptr() % 16 == 0:
        return x
    return F.pad(x, (0, ld - cols)).contiguous()


def _dims(p: DecodeInputs) -> dict:
    """The shape fields of `_DecodeArgs` for `p`."""
    w = p.w
    B, T, Dm = p.memory.shape
    return dict(
        B=B, T=T, S=p.max_steps, M=p.n_mels, P0=w.prenet_w0.shape[1],
        P1=w.prenet_w1.shape[1], Dm=Dm, A=p.keys.shape[-1], Ha=w.attn_wh.shape[0],
        Hd=w.gru0_wh.shape[0], r=p.reduction, min_steps=int(p.min_steps),
    )


def _dropout_fields(p: DecodeInputs) -> dict:
    """The dropout fields of `_DecodeArgs` for `p`: the flag, the first
    global row, the seed's 32 bits, the uint32 threshold and the scale."""
    on = p.seed is not None and p.rate > 0.0
    return dict(dropout=int(on), row0=int(p.row0), seed=int(p.seed) & _U32 if on else 0,
                threshold=keep_threshold(p.rate) if on else 0,
                dropout_scale=dropout_scale(p.rate) if on else 1.0)


def longest_fit(smem_bytes) -> int:
    """The largest T for which `smem_bytes(T)`, a library's count of one
    block's shared memory (which grows with T), fits the card; -1 if none
    does."""

    def fits(t: int) -> bool:
        return smem_bytes(t) <= build.MAX_SMEM

    if not fits(0):
        return -1
    lo, hi = 0, 1
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:  # fits(lo), not fits(hi)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def longest_text(lib: ctypes.CDLL, p: DecodeInputs) -> int:
    """The largest T at `p`'s widths whose block fits in shared memory, by
    the library's own count; -1 if none does."""
    args = _DecodeArgs(**_dims(p))

    def smem(t: int) -> int:
        args.T = t
        return lib.sstts_decode_smem_bytes(ctypes.byref(args))

    return longest_fit(smem)


def library() -> ctypes.CDLL:
    """This checkout's build of csrc/decoder.cu, bound."""
    return build.load("decoder", _SIGNATURES)


def cell_widths(cell) -> Tuple[int, ...]:
    """The widths of `cell` that fix one block's shared memory beside T:
    (M, P0, P1, Dm, A, Ha, Hd, r)."""
    a = cell.arch
    return (cell.n_mels, *a.prenet_units, cell.attn_gru.wx.shape[0] - a.prenet_units[-1],
            a.attention_units, a.attention_gru_units, a.decoder_gru_units,
            a.reduction_factor)


@functools.lru_cache(maxsize=32)
def text_reach(widths: Tuple[int, ...], device: torch.device) -> int:
    """The longest T the kernel takes at `widths` (`cell_widths`) on
    `device`, by this checkout's library's count of shared memory (builds
    it on first use; the card only), cached so that no batch pays for the
    search."""
    M, P0, P1, Dm, A, Ha, Hd, r = widths
    args = _DecodeArgs(M=M, P0=P0, P1=P1, Dm=Dm, A=A, Ha=Ha, Hd=Hd, r=r)
    lib = library()

    def smem(t: int) -> int:
        args.T = t
        return lib.sstts_decode_smem_bytes(ctypes.byref(args))

    return longest_fit(smem)


def decode_route(impl: str, T: int, reach: Optional[int]) -> str:
    """The decode a batch of T text positions takes: `impl` ("fused" or
    "xla", `resolve_decoder_impl`'s), except that "fused" past the kernel's
    `reach` (None: no limit, the plain version on the CPU) is the plain
    loop, "xla": the reference's per-shape gate (`sstts/synthesize.py:281-296`),
    for "auto" and an explicit "fused" alike.  A pure function: nothing is
    launched."""
    if impl == "fused" and reach is not None and T > reach:
        return "xla"
    return impl


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the decode library's C functions on `lib` (a build of
    csrc/decoder.cu, perhaps with other compile-time settings)."""
    for fn, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def launch(lib: ctypes.CDLL, p: DecodeInputs) -> Dict[str, torch.Tensor]:
    """Launch `lib` (`library()`, or another `bind`-ed build of
    csrc/decoder.cu) on `p`, made by `prepare_decode` on the card.  Raises
    NotImplementedError, before anything is launched, for a T whose scores
    no longer fit in shared memory beside the ring."""
    w = p.w
    dt = w.attn_wx.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"fused decode matmul dtype {dt}")
    if p.memory.dtype != dt or p.keys.dtype != dt or any(
        getattr(w, n).dtype != dt for n in _MATRICES
    ):
        raise ValueError("fused decode: weights, memory and keys must share one dtype")
    if p.packed is None or p.schedule is None:
        raise ValueError("fused decode: no packed weights or schedule (prepare_decode "
                         "packs them when the inputs are on the card)")
    dev = p.memory.device
    for t in (p.memory, p.keys, p.maskf, p.packed, p.schedule, *w):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("fused decode inputs must be contiguous on one device")
    dims = _dims(p)
    args = _DecodeArgs(**dims, **_dropout_fields(p), n_chunks=p.schedule.shape[0],
                       stop_threshold=float(p.stop_threshold))
    smem = lib.sstts_decode_smem_bytes(ctypes.byref(args))
    if smem > build.MAX_SMEM:
        raise NotImplementedError(
            f"fused decode needs {smem} bytes of shared memory (limit "
            f"{build.MAX_SMEM}) at T={dims['T']}: the ring and the T scores no "
            f"longer fit; this cell takes T up to {longest_text(lib, p)}"
        )
    B, T, S = dims["B"], dims["T"], dims["S"]
    r, M = p.reduction, p.n_mels
    out = {
        "mel": torch.empty(B, S, r * M, device=dev),
        "stop": torch.empty(B, S, r, device=dev),
        "align": torch.empty(B, S, T, device=dev),
        "fin": torch.empty(B, S, device=dev),
    }
    ptrs = {"packed": p.packed, "schedule": p.schedule, "memory": memory_panels(p.memory),
            "keys": _rows16(p.keys), "mask": p.maskf,
            **{n: getattr(w, n) for n in _VECTORS}, **out}
    for name, t in ptrs.items():
        setattr(args, name, t.data_ptr())
    rc = lib.sstts_fused_decode(
        ctypes.byref(args), int(dt == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "fused_decode")
    return out


def decode_steps(p: DecodeInputs) -> Dict[str, torch.Tensor]:
    """Device dispatch (see module docstring); counts CUDA launches in
    `decode_steps.launches`.  Inference-only: raises when grad mode is on
    and an input requires grad."""
    require_no_grad("fused_decode", p.memory, p.keys, p.maskf, *p.w)
    dev = p.memory.device.type
    if dev == "cpu":
        return decode_steps_plain(p)
    if dev != "cuda":
        raise NotImplementedError(f"fused decode on {dev}")
    out = launch(library(), p)
    decode_steps.launches += 1
    return out


decode_steps.launches = 0


def prepare_decode(
    cell,
    memory: torch.Tensor,
    memory_mask: torch.Tensor,
    max_steps: int,
    *,
    stop_threshold: float = 0.5,
    min_steps: int = 8,
    seed: Optional[int] = None,
    row0: int = 0,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> DecodeInputs:
    """Hoisted per-utterance work: the key projection (f32, as JAX), the
    casts, and on the card the matrices packed for the kernel's stream and
    its chunk schedule.  `seed` is the prenet dropout's int32 seed (at the
    cell's prenet rate), or None for no dropout; `row0` the global row of
    the batch's first row."""
    w = weights_from_cell(cell, matmul_dtype)
    keys = memory.float() @ cell.attention.memory_proj.weight.T.float()
    packed = schedule = None
    if memory.is_cuda:
        packed = pack_weights(w)
        T, Dm = memory.shape[1:]
        products = step_products(weight_layout(w), T, keys.shape[-1], Dm,
                                 w.attn_wx.element_size(), STEP_ORDER, memory.shape[0])
        # From pinned memory, so that the host does not wait for the card.
        schedule = chunk_schedule(products).pin_memory().to(memory.device, non_blocking=True)
    return DecodeInputs(
        w=w,
        memory=memory.to(matmul_dtype).contiguous(),
        keys=keys.to(matmul_dtype).contiguous(),
        maskf=memory_mask.float().contiguous(),
        seed=None if seed is None else int(seed),
        row0=int(row0),
        rate=float(cell.prenet.dropout),
        max_steps=int(max_steps),
        n_mels=cell.n_mels,
        reduction=cell.arch.reduction_factor,
        stop_threshold=float(stop_threshold),
        min_steps=int(min_steps),
        packed=packed,
        schedule=schedule,
    )


def fused_decode(cell, memory, memory_mask, max_steps, **kw) -> Dict[str, torch.Tensor]:
    """Autoregressive decode of `max_steps` steps; the same output dict as
    `Tacotron.decode_infer`: mel (B, S*r, M), stop_logits (B, S*r),
    alignments (B, S, T), n_frames (B,)."""
    p = prepare_decode(cell, memory, memory_mask, max_steps, **kw)
    out = decode_steps(p)
    B, S = out["fin"].shape
    return {
        "mel": out["mel"].reshape(B, S * p.reduction, p.n_mels),
        "stop_logits": out["stop"].reshape(B, S * p.reduction),
        "alignments": out["align"],
        "n_frames": (out["fin"] < 0.5).sum(1) * p.reduction,
    }
