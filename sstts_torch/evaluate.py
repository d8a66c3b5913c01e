"""Evaluation: the port of `sstts/evaluate.py`.

Restores the newest checkpoint, runs the teacher-forced losses over the
eval split (`make_eval_step`: B3 x4 and B6 on the card), measures
resynthesis (the eval texts decoded autoregressively by the
`Synthesizer`: B3, B4 and B2 on the card) against the ground-truth mel,
and optionally writes WAVs and plots of synthesized eval utterances under
`workdir/<inference.output_dir>`.  `device` None means the card.  Every
architecture the model takes evaluates here: a bf16 or local-Luong model
through `make_eval_step` and the `Synthesizer` (Luong's decoder and
teacher-forced scan run their plain loops on the card, B4 and B6 0).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from sstts_torch.checkpoint import CheckpointManager
from sstts_torch.config import Config
from sstts_torch.data import pipeline as pipeline_mod
from sstts_torch.data import text as text_mod
from sstts_torch.data.wav import save_wav
from sstts_torch.dsp.ops import wav_to_features
from sstts_torch.synthesize import Synthesizer, exact_f32
from sstts_torch.train import TrainState, create_state, load_corpus, make_eval_step
from sstts_torch.utils.logging import MetricsLogger


def _synthesizer(cfg: Config, state: TrainState) -> Synthesizer:
    """A Synthesizer on the state's weights and device."""
    model = state.model
    return Synthesizer(cfg, model.state_dict(), device=next(model.parameters()).device)


def evaluate_state(
    cfg: Config,
    state: TrainState,
    num_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Teacher-forced losses averaged over the eval split's batches."""
    _, eval_utts = load_corpus(cfg)
    if not eval_utts:
        raise ValueError("eval split is empty; lower eval_fraction or add data")
    batcher = pipeline_mod.Batcher(eval_utts, cfg)
    eval_step = make_eval_step(cfg)
    agg: Dict[str, float] = {}
    n = 0
    for _, batch in batcher.epoch(0, cfg.evaluation.batch_size):
        metrics, _ = eval_step(state, batch)
        for k, v in metrics.items():
            agg[k] = agg.get(k, 0.0) + float(v)
        n += 1
        if num_batches is not None and n >= num_batches:
            break
    if n == 0:
        raise ValueError(
            "eval split produced no batches: every utterance exceeded the "
            "configured text/frame buckets (check training.text_buckets / "
            "frame_buckets against the corpus)"
        )
    return {k: v / n for k, v in agg.items()}


def resynthesis_metrics(
    cfg: Config,
    state: TrainState,
    num_utterances: int = 8,
) -> Dict[str, float]:
    """Synthesize eval-split texts autoregressively and measure the mel-L1
    between the generated mel and the ground-truth features over their
    overlapping frames, and the stop token's relative length error."""
    train_utts, eval_utts = load_corpus(cfg)
    utts = (eval_utts or train_utts)[:num_utterances]
    # The batch in utterance order (the Batcher shuffles and drops by
    # bucket, which would misalign its rows with the texts).
    r = cfg.arch.reduction_factor
    items = [
        (
            text_mod.encode(
                u.text,
                extra_chars=cfg.dataset.extra_chars,
                expand_numbers=cfg.dataset.expand_numbers,
            ),
            pipeline_mod.load_audio(u, cfg),
        )
        for u in utts
    ]
    text_len = max(len(ids) for ids, _ in items)
    max_frames = max(1 + len(a) // cfg.dataset.hop_len for _, a in items)
    fr = -(-max_frames // r) * r
    batch = pipeline_mod.make_batch(items, text_len, fr, cfg)
    dev = next(state.model.parameters()).device
    with torch.no_grad(), exact_f32(dev):
        samples = torch.from_numpy(batch["samples"]).to(dev).float() * (1.0 / 32767.0)
        _, gt_mel = wav_to_features(samples, cfg.dataset)
    gt_mel = gt_mel.cpu().numpy()
    _, full = _synthesizer(cfg, state).synthesize_batch(
        [u.text for u in utts], full_output=True,
        fetch=("wav", "mel", "n_frames", "n_samples"),
    )
    l1s, len_errs = [], []
    for i in range(len(utts)):
        gt_frames = int(batch["loss_frames"][i])
        gen_frames = int(full["n_frames"][i])
        n = min(gt_frames, gen_frames)
        if n >= 8:
            l1s.append(float(np.abs(full["mel"][i, :n] - gt_mel[i, :n]).mean()))
        len_errs.append(abs(gen_frames - gt_frames) / max(gt_frames, 1))
    return {
        "resynthesis_mel_l1": float(np.mean(l1s)) if l1s else float("nan"),
        "resynthesis_len_rel_err": float(np.mean(len_errs)),
        "resynthesis_utterances": float(len(utts)),
    }


def evaluate(
    cfg: Config,
    workdir: str | Path,
    num_batches: Optional[int] = None,
    synthesize_count: int = 0,
    device=None,
) -> Dict[str, float]:
    """Restore the newest checkpoint under `workdir` onto `device` (None:
    the card), evaluate it, log an "eval" record to `metrics.jsonl`, and
    write `synthesize_count` synthesized eval utterances (WAV, and
    alignment and mel plots where matplotlib imports)."""
    ckpt = CheckpointManager(cfg, workdir)
    state = create_state(cfg, device=device)
    step = ckpt.restore_latest(state)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {workdir}")
    if cfg.inference.use_ema:
        if state.ema_params is None:
            raise ValueError(
                f"inference.use_ema: checkpoint under {workdir} stores no "
                "ema_params tree (train with training.ema_decay > 0)"
            )
        # Every consumer below (losses, resynthesis, WAVs) sees the
        # Polyak-averaged weights; the batch-norm statistics stay as stored.
        state.model.load_state_dict(state.ema_params, strict=False)
    metrics = evaluate_state(cfg, state, num_batches)
    try:
        metrics.update(resynthesis_metrics(cfg, state))
    except (ValueError, FileNotFoundError) as e:
        print(f"[warn] resynthesis metrics skipped: {e}", flush=True)
    logger = MetricsLogger(workdir)
    try:
        logger.log(step, metrics, prefix="eval")
    finally:
        logger.close()

    if synthesize_count > 0:
        _, eval_utts = load_corpus(cfg)
        outdir = Path(workdir) / cfg.inference.output_dir
        outdir.mkdir(parents=True, exist_ok=True)
        utts = eval_utts[:synthesize_count]
        wavs, full = _synthesizer(cfg, state).synthesize_batch(
            [u.text for u in utts], full_output=True,
            fetch=("wav", "mel", "alignments", "n_frames", "n_samples"),
        )
        for i, u in enumerate(utts):
            save_wav(outdir / f"eval_{u.uid}.wav", wavs[i], cfg.dataset.sample_rate)
        try:
            from sstts_torch.utils.visualization import (
                plot_attention_alignment,
                plot_spectrogram,
            )

            for i, u in enumerate(utts):
                nf = int(full["n_frames"][i])
                steps = max(1, nf // cfg.arch.reduction_factor)
                plot_attention_alignment(
                    full["alignments"][i][:steps],
                    title=f"alignment {u.uid}",
                    path=outdir / f"eval_{u.uid}_alignment.png",
                )
                plot_spectrogram(
                    full["mel"][i][:nf],
                    title=f"mel {u.uid}",
                    path=outdir / f"eval_{u.uid}_mel.png",
                )
        except ImportError:
            pass
        print(f"wrote {len(utts)} WAVs (+plots) to {outdir}")
    return metrics
