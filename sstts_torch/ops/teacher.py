"""Teacher-forced decoder scan: the port of `sstts/ops/pallas_decoder.py`
(355-645: `TeacherWeights`, `_teacher_step_math`, `fused_teacher_scan`,
`teacher_scan_xla`, `fused_teacher_scan_ad`, `supports_teacher_arch`,
`resolve_teacher_impl`), kernel B6.

Training hoists the prenet before the scan and the frame/stop projections
after it (`Tacotron.decode_teacher`), so the scan keeps only the sequential
chain: attention GRU -> Bahdanau attention -> decoder projection -> two
residual GRUs.  `fused_teacher_scan` dispatches on the device: a CPU tensor
runs `fused_teacher_scan_plain` (the port of `teacher_scan_xla`, with the
matmul dtype as an argument), a CUDA tensor launches
`sstts_torch/csrc/teacher.cu` or raises.

The kernel reads its eight matrices as one stream, as B4 does
(`sstts_torch/ops/decoder.py`): `launch` packs them in the matmul dtype,
rows padded to 16 bytes, in the order a step reads them, a product wider
than MAX_COLS in column panels (one device copy a forward, since the
weights change every train step), and takes the
shape's chunk schedule, made once for each shape and copied from pinned
memory, so that the launch never waits for the card.

Gradient (`fused_teacher_scan_ad`), the JAX package's contract
(`_teacher_ad_bwd`): the forward launches the kernel on the live
parameters, cast inside the wrapper and never detached from the graph; the
backward recomputes the scan through the plain f32 version under autograd.
A backward kernel is later work (ROADMAP B.6).

On the card that backward is some 20,000 small launches at the train
cell's shape, so `scan_grad` replays it as a CUDA graph: the first
backward of a shape (`graph_key`) runs eagerly, the second captures the
rerun and its `torch.autograd.grad` into one `torch.cuda.CUDAGraph` and
replays it, later ones replay (`ScanGraphs.route`).  A replay runs the
eager rerun's kernels on static copies of this call's inputs, and hands
autograd clones of the graph's gradients.  The CPU, and a backward under
autograd's anomaly mode (whose NaN checks wait for the card), stay eager.

Implementation choice (`resolve_teacher_impl`): "xla", the reference's
name for its scan, is the plain module loop (`DecoderCell.teacher_step`)
on any device; "auto" is the kernel on CUDA where it implements the
architecture (Bahdanau attention, 2 decoder GRUs) and the plain loop
elsewhere, as JAX's CPU "auto" is its scan; "fused" on the CPU is this
module's plain version under the same `autograd.Function`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from sstts_torch.ops import build
from sstts_torch.ops import decoder as dec
from sstts_torch.ops.decoder import _dot, _gru_step
from sstts_torch.utils.profiling import span


class TeacherWeights(NamedTuple):
    """Teacher-step parameters in kernel layout: matrices (in, out), vectors
    (N,).  The decoder cell minus the prenet and the projections."""

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


def supports_teacher_arch(arch) -> bool:
    """The kernel implements Bahdanau attention and exactly 2 decoder GRUs
    (the prenet runs outside the scan, so its depth does not matter)."""
    return arch.attention_type == "bahdanau" and arch.decoder_gru_layers == 2


def resolve_teacher_impl(override, arch, device) -> str:
    """"xla" (the plain module loop) or "fused" (this module's scan) for an
    override in (None, "auto", "xla", "fused") on `device`: "auto" is the
    kernel on CUDA where it implements the architecture, else the plain
    loop; "fused" on an architecture it lacks raises ValueError, as the
    reference does.  The kernel takes products of any width (in column
    panels, as B4).  A pure function of its arguments: nothing is
    launched."""
    impl = override or "auto"
    if impl not in ("auto", "xla", "fused"):
        raise ValueError(f"unknown teacher decoder impl: {impl!r}")
    if impl == "fused" and not supports_teacher_arch(arch):
        raise ValueError(
            "teacher decoder impl 'fused' requires Bahdanau attention and "
            "exactly 2 decoder GRUs — use 'xla' for this architecture"
        )
    cuda = torch.device(device).type == "cuda"
    if impl == "auto":
        impl = "fused" if cuda and supports_teacher_arch(arch) else "xla"
    return impl


def teacher_route(override, impl: str, T: int, reach) -> str:
    """The scan a batch of T text positions takes: `impl` (`resolve_teacher_impl`'s
    for `override`), except that under "auto" the kernel past its `reach`
    (None: no limit, the plain version on the CPU) is the plain loop, "xla",
    as the reference's "auto" is always its scan
    (`sstts/ops/pallas_decoder.py:627-645`); an explicit "fused" past the
    reach raises NotImplementedError.  Decided from the shape before any
    launch; a pure function."""
    if impl != "fused" or reach is None or T <= reach:
        return impl
    if (override or "auto") == "auto":
        return "xla"
    raise NotImplementedError(
        f"teacher decoder impl 'fused': T={T} is past the fused teacher scan's "
        f"reach (T up to {reach}); use 'auto' or 'xla' for this text width"
    )


def scan_impl(override, cell, T: int, device) -> str:
    """The scan `Tacotron.decode_teacher` runs for a batch of T text
    positions on `device`: `resolve_teacher_impl`, then on the card the
    shape gate `teacher_route` at the kernel's reach (`text_reach`)."""
    impl = resolve_teacher_impl(override, cell.arch, device)
    reach = None
    if impl == "fused" and torch.device(device).type == "cuda":
        reach = text_reach(cell_widths(cell), torch.device(device))
    return teacher_route(override, impl, T, reach)


def cell_widths(cell) -> Tuple[int, ...]:
    """The widths of `cell` that fix one block's shared memory beside T:
    (P1, Dm, A, Ha, Hd)."""
    a = cell.arch
    P1 = a.prenet_units[-1]
    return (P1, cell.attn_gru.wx.shape[0] - P1, a.attention_units, a.attention_gru_units,
            a.decoder_gru_units)


@functools.lru_cache(maxsize=32)
def text_reach(widths: Tuple[int, ...], device: torch.device) -> int:
    """The longest T the kernel takes at `widths` (`cell_widths`) on
    `device`, by this checkout's library's count of shared memory (builds
    it on first use; the card only), cached so that no step pays for the
    search."""
    P1, Dm, A, Ha, Hd = widths
    return longest_text(library(), dict(B=0, T=0, S=0, P1=P1, Dm=Dm, A=A, Ha=Ha, Hd=Hd))


def teacher_weights_from_cell(cell) -> TeacherWeights:
    """The decoder cell's live parameters (still in the autograd graph) in
    kernel layout."""
    if not supports_teacher_arch(cell.arch):
        raise NotImplementedError(
            "the fused teacher scan implements Bahdanau attention with "
            "exactly 2 decoder GRUs; this architecture is not supported"
        )
    a, g0, g1 = cell.attn_gru, cell.dec_gru0, cell.dec_gru1
    att = cell.attention
    return TeacherWeights(
        a.wx, a.wh, a.b,
        att.query_proj.weight.T, att.v, att.b,
        cell.dec_proj.weight.T, cell.dec_proj.bias,
        g0.wx, g0.wh, g0.b,
        g1.wx, g1.wh, g1.b,
    )


def _cast(w: TeacherWeights, dt: torch.dtype) -> TeacherWeights:
    """Matrices to the matmul dtype, vectors to f32."""
    return TeacherWeights(
        *[t.to(dt if t.dim() == 2 else torch.float32) for t in w]
    )


def _teacher_step_math(w: TeacherWeights, pre_t, attn_h, h0, h1, ctx,
                       memory, keys, maskf):
    """One step (pallas_decoder.py:419-444); matmuls in w's matrix dtype
    with f32 accumulation, softmax in f32.  Returns (d, align, h_a, h0_new,
    h1_new, new_ctx)."""
    h_a = _gru_step(torch.cat([pre_t, ctx], -1), attn_h, w.attn_wx, w.attn_wh, w.attn_b)
    q = _dot(h_a, w.query_w) + w.score_b
    s = torch.tanh(keys + q[:, None, :])
    scores = (s * w.score_v).sum(-1)
    scores = torch.where(maskf > 0.0, scores, torch.full_like(scores, -1e9))
    e = torch.exp(scores - scores.max(-1, keepdim=True).values)
    align = e / e.sum(-1, keepdim=True)
    new_ctx = (align[:, :, None] * memory).sum(1)
    d = _dot(torch.cat([h_a, new_ctx], -1), w.dec_w) + w.dec_b
    h0_new = _gru_step(d, h0, w.gru0_wx, w.gru0_wh, w.gru0_b)
    d = d + h0_new
    h1_new = _gru_step(d, h1, w.gru1_wx, w.gru1_wh, w.gru1_b)
    d = d + h1_new
    return d, align, h_a, h0_new, h1_new, new_ctx


def fused_teacher_scan_plain(
    w: TeacherWeights,
    pre: torch.Tensor,
    memory: torch.Tensor,
    keys: torch.Tensor,
    maskf: torch.Tensor,
    matmul_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function as a step loop (any device; differentiable in
    f32): pre (B, S, P1), memory (B, T, Dm), keys (B, T, A), maskf (B, T)
    -> xs (B, S, Hd), align (B, S, T), both f32.  memory and keys are
    rounded to the matmul dtype, as the kernel stores them."""
    wc = _cast(w, matmul_dtype)
    mem = memory.to(matmul_dtype).float()
    keys32 = keys.to(matmul_dtype).float()
    maskf = maskf.float()
    batch, steps, _ = pre.shape
    zeros = lambda n: pre.new_zeros(batch, n, dtype=torch.float32)  # noqa: E731
    attn_h, h0, h1 = zeros(w.attn_wh.shape[0]), zeros(w.gru0_wh.shape[0]), zeros(w.gru0_wh.shape[0])
    ctx = zeros(memory.shape[-1])
    xs, aligns = [], []
    for t in range(steps):
        d, align, attn_h, h0, h1, ctx = _teacher_step_math(
            wc, pre[:, t].float(), attn_h, h0, h1, ctx, mem, keys32, maskf
        )
        xs.append(d)
        aligns.append(align)
    return torch.stack(xs, 1), torch.stack(aligns, 1)


#: B6's matrices in the order a step reads them (and `pack_weights` lays
#: them out); the vectors (biases, score v) stay f32.
MATRICES = ("attn_wx", "attn_wh", "query_w", "dec_w",
            "gru0_wx", "gru0_wh", "gru1_wx", "gru1_wh")

#: The products of one step in the order the kernel reads their operands:
#: B4's steps 2-4 (`decoder.STEP_ORDER`), the chain both kernels share.
STEP_ORDER = ("attn_wx", "attn_wh", "query_w", "keys", "memory",
              "dec_w", "gru0_wx", "gru0_wh", "gru1_wx", "gru1_wh")

#: Bytes of one of the kernel's ring stages (kStageBytes in csrc/chain.cuh,
#: B4's setting too): the schedule's chunks are cut to it.
STAGE_BYTES = dec.STAGE_BYTES

#: Widest column panel of a product (kMaxCols in csrc/chain.cuh); wider
#: products are streamed in panels (`decoder.panels`).
MAX_COLS = dec.MAX_COLS

_VECTORS = tuple(n for n in TeacherWeights._fields if n not in MATRICES)


class _TeacherArgs(ctypes.Structure):
    """Mirror of `TeacherArgs` in csrc/teacher.cu (same field order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in ("packed", "schedule", *_VECTORS, "pre", "memory", "keys", "mask",
                     "xs", "align")
    ] + [
        (name, ctypes.c_int)
        for name in ("B", "T", "S", "P1", "Dm", "A", "Ha", "Hd", "n_chunks")
    ]


_SIGNATURES = {
    "sstts_fused_teacher_scan": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "sstts_teacher_smem_bytes": ([ctypes.c_void_p], ctypes.c_int),
}


def library() -> ctypes.CDLL:
    """This checkout's build of csrc/teacher.cu, bound."""
    return build.load("teacher", _SIGNATURES)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the scan library's C functions on `lib` (a build of
    csrc/teacher.cu, perhaps with other compile-time settings)."""
    for fn, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def dims(w: TeacherWeights, pre: torch.Tensor, memory: torch.Tensor,
         keys: torch.Tensor) -> dict:
    """The integer fields of `_TeacherArgs` but `n_chunks`."""
    B, S, P1 = pre.shape
    T, Dm = memory.shape[1:]
    return dict(B=B, T=T, S=S, P1=P1, Dm=Dm, A=keys.shape[-1],
                Ha=w.attn_wh.shape[0], Hd=w.gru0_wh.shape[0])


def longest_text(lib: ctypes.CDLL, d: dict) -> int:
    """The largest T at the widths of `d` (`dims`) whose block fits in
    shared memory, by the library's own count; -1 if none does."""
    args = _TeacherArgs(**d)

    def smem(t: int) -> int:
        args.T = t
        return lib.sstts_teacher_smem_bytes(ctypes.byref(args))

    return dec.longest_fit(smem)


def step_products(w: TeacherWeights, d: dict, dt: torch.dtype):
    """A step's operands in `STEP_ORDER`, the matrices as `pack_weights`
    lays them out in `dt`, each in its column panels."""
    layout = dec.weight_layout(w, MATRICES, dt)
    return dec.step_products(layout, d["T"], d["A"], d["Dm"], dt.itemsize, STEP_ORDER,
                             d["B"])


@functools.lru_cache(maxsize=64)
def _schedule(products, device: torch.device) -> torch.Tensor:
    """The chunk schedule of `products` on `device`, made once for each
    shape and copied from pinned memory, so that the host does not wait
    for the card."""
    return dec.chunk_schedule(products, STAGE_BYTES).pin_memory().to(device, non_blocking=True)


def launch(lib: ctypes.CDLL, w: TeacherWeights, pre, memory, keys, maskf,
           dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `lib` (`library()`, or another `bind`-ed build of
    csrc/teacher.cu) on live or cast weights: packs the eight matrices in
    `dt` on the card (one copy each), takes the shape's schedule, launches.
    Raises NotImplementedError, before anything is launched, for a T whose
    scores no longer fit in shared memory beside the ring."""
    if dt not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"fused teacher scan matmul dtype {dt}")
    dev = pre.device
    d = dims(w, pre, memory, keys)
    args = _TeacherArgs(**d)
    smem = lib.sstts_teacher_smem_bytes(ctypes.byref(args))
    if smem > build.MAX_SMEM:
        raise NotImplementedError(
            f"fused teacher scan needs {smem} bytes of shared memory (limit "
            f"{build.MAX_SMEM}) at T={d['T']}: the ring and the T scores no "
            f"longer fit; this cell takes T up to {longest_text(lib, d)}"
        )
    vectors = [getattr(w, n).detach().float().contiguous() for n in _VECTORS]
    ins = [pre.detach().float().contiguous(), dec.memory_panels(memory.detach().to(dt).contiguous()),
           dec._rows16(keys.detach().to(dt).contiguous()), maskf.detach().float().contiguous()]
    for t in (*w, *ins):
        if t.device != dev:
            raise ValueError("fused teacher scan inputs must lie on one device")
    with torch.no_grad():
        packed = dec.pack_weights(w, MATRICES, dt)
    schedule = _schedule(step_products(w, d, dt), dev)
    B, S, T, Hd = d["B"], d["S"], d["T"], d["Hd"]
    xs = torch.empty(B, S, Hd, device=dev)
    align = torch.empty(B, S, T, device=dev)
    args.n_chunks = schedule.shape[0]
    ptrs = {"packed": packed, "schedule": schedule, **dict(zip(_VECTORS, vectors)),
            **dict(zip(("pre", "memory", "keys", "mask"), ins)), "xs": xs, "align": align}
    for name, t in ptrs.items():
        setattr(args, name, t.data_ptr())
    rc = lib.sstts_fused_teacher_scan(
        ctypes.byref(args), int(dt == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "fused_teacher_scan")
    return xs, align


def fused_teacher_scan(
    w: TeacherWeights,
    pre: torch.Tensor,
    memory: torch.Tensor,
    keys: torch.Tensor,
    maskf: torch.Tensor,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device dispatch (see module docstring); not differentiable.  Counts
    CUDA launches in `fused_teacher_scan.launches`."""
    if pre.device.type == "cpu":
        return fused_teacher_scan_plain(w, pre, memory, keys, maskf, matmul_dtype)
    if pre.device.type != "cuda":
        raise NotImplementedError(f"fused teacher scan on {pre.device.type}")
    out = launch(library(), w, pre, memory, keys, maskf, matmul_dtype)
    fused_teacher_scan.launches += 1
    return out


fused_teacher_scan.launches = 0


def _rerun_grad(saved, dxs, dalign):
    """The gradients of the scan by its f32 rerun under autograd: `saved`
    is (maskf, pre, memory, keys, *w); one per input after maskf, None
    where the scan does not use it."""
    maskf, *inputs = saved
    leaves = [t.detach().requires_grad_() for t in inputs]
    pre, memory, keys, *w = leaves
    with torch.enable_grad():
        out = fused_teacher_scan_plain(
            TeacherWeights(*w), pre, memory, keys, maskf, torch.float32
        )
        return torch.autograd.grad(out, leaves, (dxs, dalign), allow_unused=True)


class GraphKey(NamedTuple):
    """What fixes a captured backward: the shape (B, S, T, P1, Dm, A, Ha,
    Hd), the forward's matmul dtype, the device, and the dtype and strides
    of each tensor the graph reads.  Which gradients autograd asks for is
    not part of it: the graph computes them all (as the eager rerun does),
    and a replay clones only those asked for."""

    dims: Tuple[int, ...]
    matmul_dtype: torch.dtype
    device: torch.device
    layout: Tuple[Tuple[torch.dtype, Tuple[int, ...]], ...]


def graph_key(saved, dxs, dalign, matmul_dtype) -> GraphKey:
    """The `GraphKey` of a backward of `saved` (maskf, pre, memory, keys,
    *w) and the gradients (dxs, dalign)."""
    _, pre, memory, keys, *w = saved
    d = dims(TeacherWeights(*w), pre, memory, keys)
    return GraphKey(
        tuple(d[n] for n in ("B", "S", "T", "P1", "Dm", "A", "Ha", "Hd")), matmul_dtype,
        pre.device, tuple((t.dtype, t.stride()) for t in (*saved, dxs, dalign)),
    )


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]  # static: maskf, pre, memory, keys, *w, dxs, dalign
    grads: Tuple[Optional[torch.Tensor], ...]  # static: pre, memory, keys, *w


class ScanGraphs:
    """The captured backwards by `GraphKey`, one a shape (a bucket's), and
    the keys seen.  A device's graphs share one memory pool and one
    capture stream, so that a graph beyond the first holds only its static
    inputs and gradients, a few MB.  Sharing the pool is safe: between
    replays a graph keeps only its static gradients live, which no other
    capture reuses, and every replay runs on the backward's stream, where
    the next one starts after this one's gradients are cloned."""

    def __init__(self):
        self.seen: set = set()
        self.graphs: Dict[GraphKey, _Captured] = {}
        self._pools: Dict[torch.device, tuple] = {}
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    def route(self, key: GraphKey, anomaly: bool = False) -> str:
        """"eager", "capture" or "replay" for a backward of `key`: eager off
        the card, under anomaly mode (its NaN checks wait for the card) and
        at a key's first sighting, which it notes; capture at the second;
        replay once captured."""
        if key.device.type != "cuda" or anomaly:
            return "eager"
        if key in self.graphs:
            return "replay"
        if key in self.seen:
            return "capture"
        self.seen.add(key)
        return "eager"

    def capture(self, key: GraphKey, tensors) -> _Captured:
        """Capture the rerun and its gradient for `key` on static copies of
        `tensors` (maskf, pre, memory, keys, *w, dxs, dalign) and store it;
        not yet replayed.  On a side stream, in a mode that other threads'
        CUDA calls (a prefetch thread's) cannot break."""
        dev = key.device
        if dev not in self._pools:
            self._pools[dev] = torch.cuda.graph_pool_handle()
            self._streams[dev] = torch.cuda.Stream(dev)
        static = tuple(torch.empty_like(t) for t in tensors)  # the same strides where dense
        for s, t in zip(static, tensors):
            s.copy_(t)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pools[dev], stream=self._streams[dev],
                              capture_error_mode="thread_local"):
            grads = _rerun_grad(static[:-2], *static[-2:])
        captured = self.graphs[key] = _Captured(graph, static, tuple(grads))
        return captured


#: The process's captured backwards.
GRAPHS = ScanGraphs()


def _replay(captured: _Captured, tensors, needs):
    """Copy `tensors` into the graph's inputs, replay it, and clone the
    gradients that `needs` asks for, so that no later replay overwrites
    what autograd was handed."""
    for s, t in zip(captured.inputs, tensors):
        s.copy_(t)
    with span("sstts.train.scan_graph"):
        captured.graph.replay()
        return [g.clone() if g is not None and need else None
                for g, need in zip(captured.grads, needs)]


def scan_grad(saved, dxs, dalign, matmul_dtype, needs):
    """The gradients of B6's scan for `_FusedTeacherScan.backward`, one per
    input after maskf (`needs`: which need one): eager, by a capture and
    its first replay, or by a replay (`ScanGraphs.route`).  Counts each
    call once, in `scan_grad.eager`, `.captures` or `.replays`."""
    with span("sstts.train.scan_grad"):
        key = graph_key(saved, dxs, dalign, matmul_dtype)
        route = GRAPHS.route(key, torch.is_anomaly_enabled())
        if route == "eager":
            scan_grad.eager += 1
            return _rerun_grad(saved, dxs, dalign)
        tensors = (*saved, dxs, dalign)
        if route == "capture":
            captured = GRAPHS.capture(key, tensors)
            scan_grad.captures += 1
        else:
            captured = GRAPHS.graphs[key]
            scan_grad.replays += 1
        return _replay(captured, tensors, needs)


scan_grad.eager = scan_grad.captures = scan_grad.replays = 0


class _FusedTeacherScan(torch.autograd.Function):
    """Kernel forward; backward through the plain f32 scan (JAX's
    `fused_teacher_scan_ad` contract), replayed as a CUDA graph on the
    card (`scan_grad`)."""

    @staticmethod
    def forward(ctx, maskf, matmul_dtype, pre, memory, keys, *w):
        out = fused_teacher_scan(TeacherWeights(*w), pre, memory, keys, maskf, matmul_dtype)
        ctx.save_for_backward(maskf, pre, memory, keys, *w)
        ctx.matmul_dtype = matmul_dtype
        return out

    @staticmethod
    def backward(ctx, dxs, dalign):
        grads = scan_grad(ctx.saved_tensors, dxs, dalign, ctx.matmul_dtype,
                          ctx.needs_input_grad[2:])
        return (None, None, *grads)


def fused_teacher_scan_ad(
    w: TeacherWeights,
    pre: torch.Tensor,
    memory: torch.Tensor,
    keys: torch.Tensor,
    maskf: torch.Tensor,
    matmul_dtype: torch.dtype = torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable `fused_teacher_scan` (see module docstring)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (pre, memory, keys, *w)):
        return _FusedTeacherScan.apply(maskf, matmul_dtype, pre, memory, keys, *w)
    return fused_teacher_scan(w, pre, memory, keys, maskf, matmul_dtype)
