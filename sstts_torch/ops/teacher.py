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

Gradient (`fused_teacher_scan_ad`), the JAX package's contract
(`_teacher_ad_bwd`): the forward launches the kernel on the live
parameters, cast inside the wrapper and never detached from the graph; the
backward recomputes the scan through the plain f32 version under autograd.
A backward kernel is later work (ROADMAP B.6).

Implementation choice (`resolve_teacher_impl`): on CUDA the scan always
runs the kernel, and "xla" (the JAX scan) raises; on the CPU "auto" is the
plain module loop (`DecoderCell.teacher_step`), as JAX's CPU "auto" is its
scan, and "fused" is this module's plain version under the same
`autograd.Function`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from sstts_torch.ops import build
from sstts_torch.ops.decoder import _dot, _gru_step


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


def resolve_teacher_impl(override, arch, device: torch.device) -> str:
    """"xla" (the plain module loop) or "fused" (this module's scan) for an
    override in (None, "auto", "xla", "fused") on `device`."""
    impl = override or "auto"
    if impl not in ("auto", "xla", "fused"):
        raise ValueError(f"unknown teacher decoder impl: {impl!r}")
    if device.type == "cuda":
        if impl == "xla":
            raise NotImplementedError(
                "teacher decoder impl 'xla' names the JAX scan; on CUDA the "
                "port runs the teacher-forced scan with its kernel only"
            )
        impl = "fused"
    elif impl == "auto":
        impl = "xla"
    if impl == "fused" and not supports_teacher_arch(arch):
        raise NotImplementedError(
            "the fused teacher scan implements Bahdanau attention with "
            "exactly 2 decoder GRUs; this architecture is not supported"
        )
    return impl


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


class _TeacherArgs(ctypes.Structure):
    """Mirror of `TeacherArgs` in csrc/teacher.cu (same field order)."""

    _fields_ = [
        (name, ctypes.c_void_p)
        for name in (*TeacherWeights._fields, "pre", "memory", "keys", "mask", "xs", "align")
    ] + [(name, ctypes.c_int) for name in ("B", "T", "S", "P1", "Dm", "A", "Ha", "Hd")]


_SIGNATURES = {
    "sstts_fused_teacher_scan": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "sstts_teacher_smem_bytes": ([ctypes.c_void_p], ctypes.c_int),
}


def _kernel(w, pre, memory, keys, maskf, dt):
    if dt not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"fused teacher scan matmul dtype {dt}")
    dev = pre.device
    wc = TeacherWeights(*[t.contiguous() for t in _cast(w, dt)])
    pre_c = pre.float().contiguous()
    mem_c = memory.to(dt).contiguous()
    keys_c = keys.to(dt).contiguous()
    mask_c = maskf.float().contiguous()
    B, S, P1 = pre.shape
    T, Dm = memory.shape[1:]
    A = keys.shape[-1]
    Ha, Hd = w.attn_wh.shape[0], w.gru0_wh.shape[0]
    widest = max(3 * Ha, A, 3 * Hd)
    if widest > 1024:
        raise NotImplementedError(
            f"fused teacher scan kernel keeps products up to 1024 columns "
            f"wide; this cell needs {widest}"
        )
    for t in (pre_c, mem_c, keys_c, mask_c, *wc):
        if t.device != dev:
            raise ValueError("fused teacher scan inputs must lie on one device")
    xs = torch.empty(B, S, Hd, device=dev)
    align = torch.empty(B, S, T, device=dev)
    ptr = lambda t: t.data_ptr()  # noqa: E731
    args = _TeacherArgs(
        *[ptr(t) for t in wc], ptr(pre_c), ptr(mem_c), ptr(keys_c), ptr(mask_c),
        ptr(xs), ptr(align), B, T, S, P1, Dm, A, Ha, Hd,
    )
    lib = build.load("teacher", _SIGNATURES)
    smem = lib.sstts_teacher_smem_bytes(ctypes.byref(args))
    if smem > build.MAX_SMEM:
        raise NotImplementedError(
            f"fused teacher scan state needs {smem} bytes of shared memory "
            f"(limit {build.MAX_SMEM}) at T={T}"
        )
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
    out = _kernel(w, pre, memory, keys, maskf, matmul_dtype)
    fused_teacher_scan.launches += 1
    return out


fused_teacher_scan.launches = 0


class _FusedTeacherScan(torch.autograd.Function):
    """Kernel forward; backward through the plain f32 scan (JAX's
    `fused_teacher_scan_ad` contract)."""

    @staticmethod
    def forward(ctx, maskf, matmul_dtype, pre, memory, keys, *w):
        out = fused_teacher_scan(TeacherWeights(*w), pre, memory, keys, maskf, matmul_dtype)
        ctx.save_for_backward(maskf, pre, memory, keys, *w)
        return out

    @staticmethod
    def backward(ctx, dxs, dalign):
        maskf, *inputs = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in inputs]
        pre, memory, keys, *w = leaves
        with torch.enable_grad():
            out = fused_teacher_scan_plain(
                TeacherWeights(*w), pre, memory, keys, maskf, torch.float32
            )
            grads = torch.autograd.grad(out, leaves, (dxs, dalign), allow_unused=True)
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
