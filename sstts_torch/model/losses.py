"""Training losses: the port of `sstts/model/losses.py`.

L1 on mel + L1 on the linear spectrogram, the linear term re-weighted
towards low frequencies (< 3 kHz), plus BCE on the stop token and, when its
weight is positive, the guided-attention prior.  Every term is masked by the
per-example loss frame counts, so padded batches train as unpadded ones; a
row with `loss_frames == 0` (an epoch-tail fill row) contributes nothing.

On a mesh (`group`, the data group) each term is this rank's numerator
over the global batch's denominator: the ranks' losses then sum to the
one-device loss, and so do their gradients.  A per-rank mean averaged over
the ranks is not that loss wherever the ranks' valid counts differ.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from sstts_torch.config import ArchitectureConfig, DatasetConfig
from sstts_torch.parallel.mesh import sum_over


def frame_mask_from_lengths(lengths: torch.Tensor, total: int) -> torch.Tensor:
    """(B,) lengths -> (B, total) bool mask."""
    return torch.arange(total, device=lengths.device)[None, :] < lengths[:, None]


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              group=None) -> torch.Tensor:
    m = mask[..., None].to(pred.dtype)
    num = torch.sum(torch.abs(pred - target) * m)
    den = torch.clamp(sum_over(torch.sum(m) * pred.shape[-1], group), min=1.0)
    return num / den


def stop_targets(loss_frames: torch.Tensor, total: int) -> torch.Tensor:
    """1.0 at and after each utterance's final valid frame, else 0."""
    pos = torch.arange(total, device=loss_frames.device)[None, :]
    return (pos >= (loss_frames - 1)[:, None]).float()


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE: max(x, 0) - x*z + log1p(exp(-|x|))."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits))
    )


def guided_attention_loss(
    alignments: torch.Tensor,
    text_lengths: torch.Tensor,
    decoder_steps: torch.Tensor,
    sigma: float,
    group=None,
) -> torch.Tensor:
    """Diagonal attention prior (Tachibana et al. 2017): W[s, t] =
    1 - exp(-(t/T - s/S)^2 / (2 sigma^2)) over each utterance's valid
    (decoder steps x text length) region."""
    b, s_len, t_len = alignments.shape
    dev = alignments.device
    s_pos = torch.arange(s_len, device=dev, dtype=torch.float32).reshape(1, s_len, 1)
    t_pos = torch.arange(t_len, device=dev, dtype=torch.float32).reshape(1, 1, t_len)
    steps = decoder_steps.reshape(b, 1, 1)
    texts = text_lengths.reshape(b, 1, 1)
    s_norm = s_pos / torch.clamp(steps, min=1.0)
    t_norm = t_pos / torch.clamp(texts, min=1.0)
    w = 1.0 - torch.exp(-((t_norm - s_norm) ** 2) / (2.0 * sigma**2))
    mask = ((s_pos < steps) & (t_pos < texts)).float()
    den = torch.clamp(sum_over(torch.sum(mask), group), min=1.0)
    return torch.sum(alignments * w * mask) / den


def tacotron_loss(
    outputs: Dict[str, torch.Tensor],
    mel_gt: torch.Tensor,
    linear_gt: torch.Tensor,
    loss_frames: torch.Tensor,
    arch: ArchitectureConfig,
    data: DatasetConfig,
    text_lengths: torch.Tensor = None,
    group=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics).  With a `group` the loss is this rank's share of the
    global loss (for its backward) and the metrics are the global values."""
    total = mel_gt.shape[1]
    mask = frame_mask_from_lengths(loss_frames, total)
    l_mel = masked_l1(outputs["mel"], mel_gt, mask, group)

    n_low = max(1, int(arch.loss_low_freq_hz / (data.sample_rate / 2) * data.n_linear))
    l_lin_full = masked_l1(outputs["linear"], linear_gt, mask, group)
    l_lin_low = masked_l1(outputs["linear"][..., :n_low], linear_gt[..., :n_low], mask, group)
    w = arch.loss_low_freq_weight
    l_linear = (1.0 - w) * l_lin_full + w * l_lin_low

    # The stop mask extends one group past the end so that the positive
    # class is seen; a fill row's stop mask is empty.
    stop_len = torch.where(
        loss_frames > 0,
        torch.clamp(loss_frames + arch.reduction_factor, max=total),
        torch.zeros_like(loss_frames),
    )
    stop_mask = frame_mask_from_lengths(stop_len, total).float()
    bce = sigmoid_bce(outputs["stop_logits"], stop_targets(loss_frames, total))
    l_stop = torch.sum(bce * stop_mask) / torch.clamp(
        sum_over(torch.sum(stop_mask), group), min=1.0
    )

    loss = l_mel + l_linear + arch.stop_token_weight * l_stop
    metrics = {"loss_mel": l_mel, "loss_linear": l_linear, "loss_stop": l_stop}
    if arch.guided_attention_weight > 0.0 and text_lengths is not None:
        dec_steps = torch.ceil(loss_frames.float() / arch.reduction_factor)
        l_attn = guided_attention_loss(
            outputs["alignments"], text_lengths.float(), dec_steps,
            arch.guided_attention_sigma, group,
        )
        loss = loss + arch.guided_attention_weight * l_attn
        metrics["loss_attn"] = l_attn
    metrics["loss"] = loss
    if group is not None:
        names = list(metrics)
        total_ = sum_over(torch.stack([metrics[k].detach() for k in names]), group)
        metrics = dict(zip(names, total_.unbind()))
    return loss, metrics
