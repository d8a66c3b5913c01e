"""The Tacotron model: the port of `sstts/model/tacotron.py`.

char embedding -> pre-net -> CBHG encoder -> (attention GRU, Bahdanau or
local-Luong attention, residual GRU stack, r frames/step) -> post-CBHG ->
linear spectrogram.
Module and parameter names follow the flax tree (see
`sstts_torch.convert`).

`forward` is the teacher-forced training forward (JAX's `__call__`); the
module's mode plays JAX's `train` flag: in `train()` batch norm uses
masked batch statistics and both prenets drop out, in `eval()` batch norm
uses its running statistics and only the decoder prenet drops out (when
`prenet_dropout_at_inference`, Tacotron-1's behaviour).  Dropout masks come
from the `torch.Generator` the caller passes.  The teacher-forced scan runs
the fused kernel on CUDA and, on the CPU, the plain module loop unless
`teacher_impl="fused"` (`sstts_torch.ops.teacher.resolve_teacher_impl`;
"auto" takes the plain loop on the card too where the kernel lacks the
architecture, as for local-Luong attention, and for a text width past the
kernel's reach, `sstts_torch.ops.teacher.teacher_route`, where an explicit
"fused" raises).

`arch.compute_dtype` is flax's compute dtype (`compute_dtype`): the
parameters stay f32, the embedding, dense layers, convolutions and batch
norm's output are in the compute dtype, the GRUs and the softmax in f32,
and `forward` returns f32 for the losses (`sstts/model/tacotron.py:30-238`).
The fused teacher scan takes the prenet output in f32 and its outputs are
cast back to the compute dtype.

On a mesh (`sstts_torch.parallel.mesh.shard_model` sets `mesh`) the model
holds a shard of the embedding's feature columns and of the post-net
projection's input rows: the lookup is gathered over the model group and
the projection's partial products summed over it before the bias, as the
reference's GSPMD program computes them (`sstts/parallel/mesh.py:58-61`).
`forward(..., rows=(start, total))` says that the batch is rows
[start, start + B) of a global batch of `total`: the prenets' keep masks
are drawn for the global batch and sliced, so the ranks of a mesh drop out
as one device would.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sstts_torch.config import ArchitectureConfig, DatasetConfig
from sstts_torch.data.text import charset_for
from sstts_torch.model.attention import BahdanauAttention, linear
from sstts_torch.model.decoder import DecoderCell, teacher_inputs
from sstts_torch.model.modules import CBHG, Conv1dBank, Highway, PreNet
from sstts_torch.model.rnn import _GRUParams
from sstts_torch.ops import decoder as dec_ops
from sstts_torch.ops import teacher as teacher_ops


def compute_dtype(arch: ArchitectureConfig) -> torch.dtype:
    """The torch dtype `arch.compute_dtype` names (the reference's rule:
    "bfloat16" is bf16, anything else f32)."""
    return torch.bfloat16 if arch.compute_dtype == "bfloat16" else torch.float32


def _keep_masks(prenet: PreNet, shape, generator, active: bool, rows=None):
    """The prenet's keep masks when its dropout is active, else None; with
    `rows` = (start, total), drawn for `total` rows and sliced to this
    batch's."""
    if not active or prenet.dropout <= 0.0:
        return None
    if generator is None:
        raise ValueError("prenet dropout is active: pass a torch.Generator")
    if rows is None:
        return prenet.keep_masks(tuple(shape), generator)
    start, total = rows
    masks = prenet.keep_masks((total, *shape[1:]), generator)
    return [m[start : start + shape[0]] for m in masks]


class Tacotron(nn.Module):
    def __init__(
        self,
        arch: ArchitectureConfig,
        data: DatasetConfig,
        teacher_impl: Optional[str] = None,
        teacher_dtype: Optional[torch.dtype] = None,
    ):
        """`teacher_impl` ("auto", "xla" or "fused"; None = "auto") picks the
        teacher-forced scan; `teacher_dtype` is the fused scan's matmul
        dtype (None: bf16 on CUDA, f32 on the CPU, as the JAX package takes
        bf16 on its TPU and f32 elsewhere).  The compute dtype is
        `arch.compute_dtype`'s."""
        super().__init__()
        a = arch
        self.arch = arch
        self.data = data
        self.dtype = dt = compute_dtype(arch)
        self.teacher_impl = teacher_impl
        self.teacher_dtype = teacher_dtype
        vocab = a.vocab_size or charset_for(data.extra_chars).vocab_size
        self.embedding = nn.Embedding(vocab, a.embedding_dim)
        self.encoder_prenet = PreNet(a.embedding_dim, a.prenet_units, a.prenet_dropout, dt)
        self.encoder_cbhg = CBHG(
            a.prenet_units[-1], a.encoder_bank_k, a.encoder_bank_channels,
            a.encoder_proj_channels, a.encoder_highway_layers,
            a.encoder_highway_units, a.encoder_gru_units, dt, a.fused_conv_bank,
        )
        memory_dim = 2 * a.encoder_gru_units
        self.decoder_cell = DecoderCell(a, data.n_mels, memory_dim, dt)
        # The second post projection returns to mel space by definition.
        post_proj = (a.post_proj_channels[0], data.n_mels)
        self.post_cbhg = CBHG(
            data.n_mels, a.post_bank_k, a.post_bank_channels, post_proj,
            a.post_highway_layers, a.post_highway_units, a.post_gru_units, dt,
            a.fused_conv_bank,
        )
        self.linear_proj = nn.Linear(2 * a.post_gru_units, data.n_linear)
        self.mesh = None

    def embed(self, char_ids: torch.Tensor) -> torch.Tensor:
        """flax's `Embed(dtype=...)`: the table in the compute dtype, then
        the lookup (of this rank's columns, gathered, on a mesh)."""
        x = F.embedding(char_ids, self.embedding.weight.to(self.dtype))
        if self.mesh is not None and self.mesh.tp:
            from sstts_torch.parallel.mesh import gather_from_group

            x = gather_from_group(x, self.mesh.model_group, dim=-1)
        return x

    def encode(
        self, char_ids: torch.Tensor, generator: Optional[torch.Generator] = None,
        rows=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, T) ids -> memory (B, T, 2*enc_gru), mask (B, T) bool.  The
        encoder prenet's dropout is train-time only."""
        mask = char_ids != 0
        x = self.embed(char_ids)
        keep = _keep_masks(self.encoder_prenet, x.shape[:2], generator, self.training, rows)
        x = self.encoder_prenet(x, keep)
        return self.encoder_cbhg(x, mask), mask

    def decode_teacher(
        self,
        memory: torch.Tensor,
        memory_mask: torch.Tensor,
        mel_gt: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        rows=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Teacher-forced scan -> (mel (B, F, M), stop_logits (B, F),
        alignments (B, S, T)).  The prenet runs before the scan on all the
        teacher frames at once, the frame/stop projections after it on the
        stacked features."""
        cell = self.decoder_cell
        r = self.arch.reduction_factor
        inputs = teacher_inputs(mel_gt, r)
        batch, steps, _ = inputs.shape
        active = self.training or self.arch.prenet_dropout_at_inference
        pre = cell.prenet(
            inputs, _keep_masks(cell.prenet, (batch, steps), generator, active, rows)
        )
        keys = cell.attention.init_keys(memory)
        dev = memory.device
        if teacher_ops.scan_impl(self.teacher_impl, cell, memory.shape[1], dev) == "fused":
            dt = self.teacher_dtype or (
                torch.bfloat16 if dev.type == "cuda" else torch.float32
            )
            xs, alignments = teacher_ops.fused_teacher_scan_ad(
                teacher_ops.teacher_weights_from_cell(cell), pre.float(), memory, keys,
                memory_mask.float(), dt,
            )
            xs, alignments = xs.to(self.dtype), alignments.to(self.dtype)
        else:
            carry = cell.init_carry(memory)
            outs = []
            for step in range(steps):
                carry, out = cell.teacher_step(carry, pre[:, step], memory, keys, memory_mask)
                outs.append(out)
            xs = torch.stack([x for x, _ in outs], 1)
            alignments = torch.stack([al for _, al in outs], 1)
        mel = linear(xs, cell.frame_proj, self.dtype).reshape(batch, steps * r, self.data.n_mels)
        stops = linear(xs, cell.stop_proj, self.dtype).reshape(batch, steps * r)
        return mel, stops, alignments

    def decode_infer(
        self,
        memory: torch.Tensor,
        memory_mask: torch.Tensor,
        max_steps: int,
        stop_threshold: float = 0.5,
        min_steps: int = 8,
        seed: Optional[int] = None,
        row0: int = 0,
    ) -> Dict[str, torch.Tensor]:
        """Autoregressive fixed-length loop with stop-token mask
        accumulation (the plain path).  `seed` is the prenet dropout's int32
        seed, or None for no dropout: the keep masks are the fused
        decode's (`sstts_torch.ops.decoder.keep_masks`, step t from seed +
        t, global rows from `row0`), so both decodes drop the same units.
        Returns mel (B, S*r, M), stop_logits (B, S*r), alignments (B, S, T),
        n_frames."""
        cell = self.decoder_cell
        r = self.arch.reduction_factor
        batch = memory.shape[0]
        keys = cell.attention.init_keys(memory)
        carry = cell.init_carry(memory)
        keep = dec_ops.keep_masks(seed, row0, max_steps, batch, cell.prenet.units,
                                  cell.prenet.dropout, memory.device)
        outs = []
        for step in range(max_steps):
            k = None if keep is None else [m[step] for m in keep]
            new, out = cell(carry, memory, keys, memory_mask, k, stop_threshold)
            fin = new.finished & (step >= min_steps - 1)
            carry = new._replace(finished=carry.finished | fin)
            outs.append(out)
        mel = torch.stack([o.mel for o in outs], 1)
        finished = torch.stack([o.finished for o in outs], 1)
        return {
            "mel": mel.reshape(batch, max_steps * r, self.data.n_mels),
            "stop_logits": torch.stack([o.stop_logits for o in outs], 1).reshape(
                batch, max_steps * r
            ),
            "alignments": torch.stack([o.alignment for o in outs], 1),
            "n_frames": (~finished).sum(1) * r,
        }

    def postprocess(
        self, mel: torch.Tensor, frame_mask: Optional[torch.Tensor]
    ) -> torch.Tensor:
        """Predicted mel -> linear spectrogram via the post-processing CBHG
        (on a mesh, this rank's input rows of the projection, the partial
        products summed over the model group, then the bias)."""
        y = self.post_cbhg(mel, frame_mask)
        if self.mesh is None or not self.mesh.tp:
            return linear(y, self.linear_proj, self.dtype)
        from sstts_torch.parallel.mesh import copy_to_group, reduce_from_group

        group, proj = self.mesh.model_group, self.linear_proj
        k = proj.weight.shape[1]
        y = copy_to_group(y, group)[..., self.mesh.model_index * k : (self.mesh.model_index + 1) * k]
        part = F.linear(y.to(self.dtype), proj.weight.to(self.dtype))
        return reduce_from_group(part, group) + proj.bias.to(self.dtype)

    def forward(
        self,
        char_ids: torch.Tensor,
        mel_gt: torch.Tensor,
        frame_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        rows=None,
    ) -> Dict[str, torch.Tensor]:
        """Teacher-forced forward: mel, linear, stop_logits, alignments."""
        memory, memory_mask = self.encode(char_ids, generator, rows)
        mel, stops, alignments = self.decode_teacher(
            memory, memory_mask, mel_gt, generator, rows
        )
        linear = self.postprocess(mel, frame_mask)
        return {
            "mel": mel.float(),
            "linear": linear.float(),
            "stop_logits": stops.float(),
            "alignments": alignments.float(),
        }


def init_state_dict(
    arch: ArchitectureConfig, data: DatasetConfig, seed: int = 0
) -> Dict[str, torch.Tensor]:
    """A seeded random init on the CPU, with the JAX package's initialiser
    families: LeCun-normal kernels, orthogonal recurrent weights, zero
    biases, highway gate bias -1, Bahdanau v ~ U(-1, 1)/sqrt(A) (local-Luong
    has only its two LeCun-normal projections), batch-norm running stats at
    mean 0 and var 1."""
    g = torch.Generator().manual_seed(int(seed))
    model = Tacotron(arch, data)

    def lecun(t: torch.Tensor, fan_in: int) -> None:
        with torch.no_grad():
            t.normal_(0.0, fan_in ** -0.5, generator=g)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                lecun(mod.weight, mod.in_features)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Conv1d):
                lecun(mod.weight, mod.in_channels * mod.kernel_size[0])
            elif isinstance(mod, Conv1dBank):
                for k in range(1, mod.bank_k + 1):
                    w = getattr(mod, f"conv{k}")
                    lecun(w, w.shape[1] * k)
            elif isinstance(mod, _GRUParams):
                lecun(mod.wx, mod.wx.shape[0])
                nn.init.orthogonal_(mod.wh, generator=g)
                mod.b.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=g)
        for mod in model.modules():
            if isinstance(mod, Highway):
                mod.t.bias.fill_(-1.0)
        att = model.decoder_cell.attention
        if isinstance(att, BahdanauAttention):
            units = att.v.shape[0]
            att.v.uniform_(-1.0, 1.0, generator=g).mul_(units ** -0.5)
            att.b.zero_()
    return model.state_dict()
