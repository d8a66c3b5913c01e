"""The attention-GRU decoder cell: the port of `sstts/model/decoder.py`
(49-228).

One autoregressive step: prenet -> attention GRU -> attention (Bahdanau or
local-Luong, `make_attention`) -> decoder projection -> residual GRU stack
-> r mel frames and r stop logits.  Once an utterance has finished, every carry freezes and its frames
are zeroed; the stop check is sigmoid(max over r) > threshold.  This is
the plain path that `Tacotron.decode_infer` loops; the fused CUDA decode is
`sstts_torch.ops.decoder`.  `teacher_step` is the teacher-forced step with
the prenet and the projections hoisted out (the plain path of
`Tacotron.decode_teacher`; the fused scan is `sstts_torch.ops.teacher`).

Under a bf16 compute dtype the carry is kept in it: the attention's f32
alignment and context and the attention GRU's state are cast back after
each step (`sstts/model/decoder.py:112-115`), as the reference's scan does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from sstts_torch.config import ArchitectureConfig
from sstts_torch.model.attention import attention_context, linear, make_attention
from sstts_torch.model.modules import PreNet
from sstts_torch.model.rnn import GRUCell


class DecoderCarry(NamedTuple):
    attn_h: torch.Tensor  # (B, Ha)
    dec_hs: Tuple[torch.Tensor, ...]  # each (B, Hd)
    context: torch.Tensor  # (B, Dm)
    alignment: torch.Tensor  # (B, T)
    prev_frame: torch.Tensor  # (B, n_mels)
    finished: torch.Tensor  # (B,) bool


class StepOutput(NamedTuple):
    mel: torch.Tensor  # (B, r, n_mels)
    stop_logits: torch.Tensor  # (B, r)
    alignment: torch.Tensor  # (B, T)
    finished: torch.Tensor  # (B,) finished before this step's emission


class DecoderCell(nn.Module):
    def __init__(self, arch: ArchitectureConfig, n_mels: int, memory_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        a = arch
        self.arch = arch
        self.n_mels = n_mels
        self.dtype = dtype
        self.prenet = PreNet(n_mels, a.prenet_units, a.prenet_dropout, dtype)
        self.attention = make_attention(
            a.attention_type, memory_dim, a.attention_gru_units, a.attention_units,
            dtype, a.local_attention_window,
        )
        self.attn_gru = GRUCell(a.prenet_units[-1] + memory_dim, a.attention_gru_units, dtype)
        self.dec_proj = nn.Linear(a.attention_gru_units + memory_dim, a.decoder_gru_units)
        for i in range(a.decoder_gru_layers):
            setattr(
                self, f"dec_gru{i}",
                GRUCell(a.decoder_gru_units, a.decoder_gru_units, dtype),
            )
        self.frame_proj = nn.Linear(a.decoder_gru_units, a.reduction_factor * n_mels)
        self.stop_proj = nn.Linear(a.decoder_gru_units, a.reduction_factor)

    @property
    def dec_grus(self):
        return [getattr(self, f"dec_gru{i}") for i in range(self.arch.decoder_gru_layers)]

    def init_carry(self, memory: torch.Tensor) -> DecoderCarry:
        a = self.arch
        batch, t_enc, memory_dim = memory.shape
        z = lambda n: memory.new_zeros(batch, n, dtype=self.dtype)  # noqa: E731
        align0 = z(t_enc)
        align0[:, 0] = 1.0
        return DecoderCarry(
            attn_h=z(a.attention_gru_units),
            dec_hs=tuple(z(a.decoder_gru_units) for _ in range(a.decoder_gru_layers)),
            context=z(memory_dim),
            alignment=align0,
            prev_frame=z(self.n_mels),
            finished=torch.zeros(batch, dtype=torch.bool, device=memory.device),
        )

    def _sequential_chain(self, carry, prenet_out, memory, keys, memory_mask):
        """The per-step chain shared by `forward` and `teacher_step`:
        attention GRU -> attention -> residual GRU stack.  Returns (attn_h,
        alignment, context, new_dec_hs, x)."""
        attn_h = self.attn_gru(torch.cat([prenet_out, carry.context], dim=-1), carry.attn_h)
        alignment = self.attention(attn_h, keys, memory_mask, carry.alignment)
        context = attention_context(alignment, memory)
        # The softmax runs in f32; the carry stays in the compute dtype.
        alignment, context = alignment.to(self.dtype), context.to(self.dtype)
        attn_h = attn_h.to(self.dtype)
        x = linear(torch.cat([attn_h, context], dim=-1), self.dec_proj, self.dtype)
        new_dec_hs = []
        for gru, h in zip(self.dec_grus, carry.dec_hs):
            h_new = gru(x, h)
            new_dec_hs.append(h_new)
            x = x + h_new  # residual connection
        return attn_h, alignment, context, tuple(new_dec_hs), x

    def teacher_step(
        self,
        carry: DecoderCarry,
        prenet_out: torch.Tensor,
        memory: torch.Tensor,
        keys: torch.Tensor,
        memory_mask: Optional[torch.Tensor],
    ) -> Tuple[DecoderCarry, Tuple[torch.Tensor, torch.Tensor]]:
        """One teacher-forced step on a hoisted prenet output: (new carry,
        (x, alignment)), x being the feature the projections consume."""
        attn_h, alignment, context, new_dec_hs, x = self._sequential_chain(
            carry, prenet_out, memory, keys, memory_mask
        )
        new_carry = carry._replace(
            attn_h=attn_h, dec_hs=new_dec_hs, context=context, alignment=alignment
        )
        return new_carry, (x, alignment)

    def forward(
        self,
        carry: DecoderCarry,
        memory: torch.Tensor,
        keys: torch.Tensor,
        memory_mask: Optional[torch.Tensor],
        keep=None,
        stop_threshold: float = 0.5,
    ) -> Tuple[DecoderCarry, StepOutput]:
        """One autoregressive step; `keep` is the prenet's per-layer keep
        masks for this step (None: no dropout)."""
        a = self.arch
        pre = self.prenet(carry.prev_frame, keep)
        attn_h, alignment, context, new_dec_hs, x = self._sequential_chain(
            carry, pre, memory, keys, memory_mask
        )
        mel = linear(x, self.frame_proj, self.dtype).reshape(-1, a.reduction_factor, self.n_mels)
        stop_logits = linear(x, self.stop_proj, self.dtype)

        fin = carry.finished

        def keep_old(new, old):
            return torch.where(fin.reshape((-1,) + (1,) * (new.dim() - 1)), old, new)

        mel = torch.where(fin[:, None, None], torch.zeros_like(mel), mel)
        new_carry = DecoderCarry(
            attn_h=keep_old(attn_h, carry.attn_h),
            dec_hs=tuple(keep_old(nh, oh) for nh, oh in zip(new_dec_hs, carry.dec_hs)),
            context=keep_old(context, carry.context),
            alignment=keep_old(alignment, carry.alignment),
            prev_frame=keep_old(mel[:, -1, :], carry.prev_frame),
            finished=fin | (torch.sigmoid(stop_logits.max(dim=-1).values) > stop_threshold),
        )
        return new_carry, StepOutput(mel, stop_logits, alignment, fin)


def group_frames(mel: torch.Tensor, r: int) -> torch.Tensor:
    """(B, F, M) -> (B, F // r, r, M); F must be a multiple of r."""
    b, f, m = mel.shape
    if f % r:
        raise ValueError(f"frame count {f} not a multiple of reduction factor {r}")
    return mel.reshape(b, f // r, r, m)


def teacher_inputs(mel_gt: torch.Tensor, r: int) -> torch.Tensor:
    """Teacher-forcing inputs, (B, F, M) -> (B, F // r, M): the last frame
    of each previous r-group; step 0 receives the zero <GO> frame."""
    last = group_frames(mel_gt, r)[:, :, -1, :]
    return torch.nn.functional.pad(last[:, :-1], (0, 0, 1, 0))
