"""Training: the port of `sstts/train.py` (43-228, 635-663, 737-996) for one
device, fed from the host.

A train step takes a batch of PCM16 waveforms and padded text ids, computes
the linear and mel targets on the device, runs the teacher-forced forward in
train mode, the masked L1 + L1 + stop loss and its gradient, clips the
gradient by its global norm and applies Adam with the staircase-decayed
learning rate.  PyTorch updates the state in place: `TrainState` holds the
model (its parameters and batch-norm running statistics), the optimizer and
the step, and a step returns only its metrics.

On the card the path runs the hand-written kernels: the four BiGRU
directions forward and backward (`sstts_torch.ops.gru`) and the
teacher-forced scan (`sstts_torch.ops.teacher`); on the CPU, their plain
versions.  Dropout draws from a `torch.Generator` seeded from
`training.seed` and the step (JAX folds the step into a key derived from
the same seed); the two streams differ, so parity with JAX runs at
`prenet_dropout=0`.

`load_corpus` reads an LJSpeech-, Blizzard-Nancy- or CSS10-layout corpus
from disk, or makes the synthetic one.  `train` logs through
`sstts_torch.utils.logging.MetricsLogger`, in the JAX package's record
shape, with the eval media (alignment and mel images, Griffin-Lim audio of
the last eval batch).  Not ported yet (ROADMAP A.6): the device-resident
corpus, grouped steps (`steps_per_call > 1`), the background prefetch,
`debug_nans` and meshes.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from sstts_torch.checkpoint import CheckpointManager
from sstts_torch.config import Config
from sstts_torch.data import pipeline as pipeline_mod
from sstts_torch.data.ljspeech import load_metadata, train_eval_split
from sstts_torch.data.synthetic import make_utterances
from sstts_torch.dsp.ops import wav_to_features
from sstts_torch.model.losses import frame_mask_from_lengths, tacotron_loss
from sstts_torch.model.tacotron import Tacotron, init_state_dict
from sstts_torch.synthesize import exact_f32, resolve_device
from sstts_torch.utils.logging import MetricsLogger


@dataclasses.dataclass
class TrainState:
    step: int
    model: Tacotron
    optimizer: torch.optim.Adam
    #: Polyak-averaged parameters by name (training.ema_decay > 0), else None.
    ema_params: Optional[Dict[str, torch.Tensor]] = None


def lr_schedule(cfg: Config) -> Callable[[int], float]:
    """Staircase exponential decay with the `lr_min` floor, evaluated at the
    step before its increment (optax.exponential_decay's semantics)."""
    t = cfg.training
    if t.lr_decay_steps <= 0:
        raise ValueError(f"training.lr_decay_steps must be positive: {t.lr_decay_steps}")
    clip = max if t.lr_decay_rate < 1.0 else min

    def sched(step: int) -> float:
        if step <= 0:
            return t.learning_rate
        value = t.learning_rate * t.lr_decay_rate ** (step // t.lr_decay_steps)
        return clip(value, t.lr_min)

    return sched


def check_trainable(cfg: Config) -> None:
    """Raise NotImplementedError for training settings this port does not
    implement (ROADMAP A names each)."""
    a, t = cfg.arch, cfg.training
    if a.fused_conv_bank:
        raise NotImplementedError("fused_conv_bank=True is not ported yet (ROADMAP A)")
    if a.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={a.compute_dtype!r} is not ported yet (ROADMAP A)"
        )
    if t.device_corpus_cache == "on" or t.steps_per_call > 1:
        raise NotImplementedError(
            "the device-resident corpus and grouped steps are not ported yet "
            "(ROADMAP A.6); the port feeds batches from the host"
        )
    if t.model_parallel > 1:
        raise NotImplementedError("model_parallel > 1 is not ported yet (ROADMAP A)")
    if t.debug_nans:
        raise NotImplementedError("training.debug_nans is not ported yet (ROADMAP A.6)")
    if not 0.0 <= t.ema_decay < 1.0:
        raise ValueError(f"training.ema_decay must be in [0, 1): {t.ema_decay}")


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    t = cfg.training
    return torch.optim.Adam(
        params, lr=t.learning_rate, betas=(t.adam_beta1, t.adam_beta2), eps=t.adam_eps
    )


def create_state(cfg: Config, seed: Optional[int] = None, device=None) -> TrainState:
    """A seeded random init (`init_state_dict`) on `device` (None: the card)
    with fresh Adam moments."""
    check_trainable(cfg)
    dev = resolve_device(device)
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(
        init_state_dict(cfg.arch, cfg.dataset, cfg.training.seed if seed is None else seed)
    )
    model.to(dev)
    ema = None
    if cfg.training.ema_decay > 0.0:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(0, model, make_optimizer(cfg, model.parameters()), ema)


def _to_device(batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}


def _targets(b: Dict[str, torch.Tensor], cfg: Config):
    """PCM16 samples -> (linear, mel, frame mask) on the batch's device."""
    with torch.no_grad():
        samples = b["samples"].float() * (1.0 / 32767.0)
        linear_gt, mel_gt = wav_to_features(samples, cfg.dataset, cfg.training.feature_fft_impl)
    return linear_gt, mel_gt, frame_mask_from_lengths(b["n_frames"], mel_gt.shape[1])


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def make_train_step(cfg: Config):
    """(state, batch) -> metrics, updating `state` in place.  `batch` holds
    the `pipeline.make_batch` fields as numpy arrays or tensors."""
    check_trainable(cfg)
    t = cfg.training
    sched = lr_schedule(cfg)

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model = state.model
        dev = _device_of(state)
        b = _to_device(batch, dev)
        gen = torch.Generator(device=dev).manual_seed(((t.seed + 1) << 32) + state.step)
        model.train()
        with exact_f32(dev):
            linear_gt, mel_gt, frame_mask = _targets(b, cfg)
            out = model(b["char_ids"], mel_gt, frame_mask, gen)
            loss, metrics = tacotron_loss(
                out, mel_gt, linear_gt, b["loss_frames"], cfg.arch, cfg.dataset,
                text_lengths=b["text_len"],
            )
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            params = list(model.parameters())
            for p in params:  # optax updates every leaf, a zero gradient too
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            g_norm = global_norm([p.grad for p in params])
            # optax.clip_by_global_norm: g / ||g|| * max_norm once ||g|| >= max_norm.
            keep = g_norm < t.grad_clip_norm
            for p in params:
                p.grad = torch.where(keep, p.grad, p.grad / g_norm * t.grad_clip_norm)
            lr = sched(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
        if state.ema_params is not None and t.ema_decay > 0.0:
            d = t.ema_decay
            with torch.no_grad():
                for n, p in model.named_parameters():
                    state.ema_params[n] = state.ema_params[n] * d + p * (1.0 - d)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = g_norm.detach()
        metrics["lr"] = torch.tensor(lr, dtype=torch.float32)
        return metrics

    return train_step


def make_eval_step(cfg: Config):
    """(state, batch) -> (metrics, outputs): teacher-forced, no gradient,
    running batch-norm statistics; the decoder prenet drops out as at
    inference (a generator seeded 0, as JAX's eval key is PRNGKey(0))."""

    def eval_step(state: TrainState, batch):
        model = state.model
        dev = _device_of(state)
        b = _to_device(batch, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        model.eval()
        with torch.no_grad(), exact_f32(dev):
            linear_gt, mel_gt, frame_mask = _targets(b, cfg)
            out = model(b["char_ids"], mel_gt, frame_mask, gen)
            _, metrics = tacotron_loss(
                out, mel_gt, linear_gt, b["loss_frames"], cfg.arch, cfg.dataset,
                text_lengths=b["text_len"],
            )
        return metrics, out

    return eval_step


def load_corpus(cfg: Config):
    """(train, eval) utterances of the corpus `dataset.dataset` names:
    "ljspeech" / "csv" (`metadata.csv` + `wavs/`), "blizzard_nancy"
    (`prompts.data` + `wavn/`), "css10" (`transcript.txt`) or "synthetic"
    (made in memory; its eval share is at least 0.05)."""
    ds = cfg.dataset
    if ds.dataset == "synthetic":
        utts = make_utterances(ds.synthetic_size, ds)
        return train_eval_split(utts, max(ds.eval_fraction, 0.05))
    if ds.dataset in ("ljspeech", "csv"):
        return train_eval_split(load_metadata(ds), ds.eval_fraction)
    if ds.dataset in ("blizzard_nancy", "css10"):
        from sstts_torch.data import corpora

        loader = {
            "blizzard_nancy": corpora.load_blizzard_nancy,
            "css10": corpora.load_css10,
        }[ds.dataset]
        return train_eval_split(loader(ds), ds.eval_fraction)
    raise ValueError(f"unknown dataset kind: {ds.dataset!r}")


def _log_eval_media(logger: MetricsLogger, step: int, cfg: Config, out) -> None:
    """The alignment and mel images and the Griffin-Lim audio of the first
    row of an eval batch's outputs.  A failure is printed, never raised
    (media logging must not end a run)."""
    if out is None:
        return
    try:
        from sstts_torch.dsp.griffin_lim import spectrogram_to_wav
        from sstts_torch.utils import visualization as viz

        align = out["alignments"][0].cpu().numpy()
        mel = out["mel"][0].cpu().numpy()
        logger.log_image(step, "eval/alignment", viz.plot_attention_alignment(align))
        logger.log_image(step, "eval/mel", viz.plot_spectrogram(mel, "predicted mel"))
        linear = out["linear"][:1]
        n_frames = linear.shape[1]
        with torch.inference_mode(), exact_f32(linear.device):
            wav = spectrogram_to_wav(linear, cfg, (n_frames - 1) * cfg.dataset.hop_len)
        logger.log_audio(step, "eval/audio", wav[0].cpu().numpy(), cfg.dataset.sample_rate)
    except Exception as e:
        print(f"[warn] eval media logging failed: {type(e).__name__}: {e}", flush=True)


def train(
    cfg: Config,
    workdir: str | Path = "runs/default",
    max_steps: Optional[int] = None,
    device=None,
    log_every: Optional[int] = None,
) -> TrainState:
    """Training driver: host-fed batches -> train steps -> metrics
    (`workdir/metrics.jsonl`), checkpoints every `checkpoint_every` steps
    and at the end, and an evaluation at most every `eval_every` steps.
    Resumes from the newest checkpoint under `workdir`, continuing the data
    order."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    t = cfg.training
    max_steps = max_steps or t.max_steps
    log_every = log_every or t.summary_every
    train_utts, eval_utts = load_corpus(cfg)
    batcher = pipeline_mod.Batcher(train_utts, cfg)
    eval_batcher = pipeline_mod.Batcher(eval_utts, cfg) if eval_utts else None
    state = create_state(cfg, device=device)
    ckpt = CheckpointManager(cfg, workdir)
    if ckpt.restore_latest(state) is not None:
        print(f"resumed from checkpoint at step {state.step}", flush=True)
    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    spe = batcher.batches_per_epoch(t.batch_size)
    if spe == 0:
        raise ValueError(
            "the epoch produced zero batches: every utterance exceeded the "
            "configured buckets or the corpus is empty"
        )
    epoch, skip = divmod(state.step, spe)
    last_eval, last_log, t_last = state.step, state.step, time.time()
    logger = MetricsLogger(workdir)
    try:
        while state.step < max_steps:
            batches = itertools.islice(batcher.epoch(t.seed + epoch, t.batch_size), skip, None)
            skip = 0
            for _, batch in batches:
                metrics = train_step(state, batch)
                step = state.step
                if step % log_every == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    now = time.time()
                    host["steps_per_s"] = (step - last_log) / max(now - t_last, 1e-9)
                    last_log, t_last = step, now
                    logger.log(step, host)
                if step % t.checkpoint_every == 0:
                    ckpt.save(step, state)
                if step >= max_steps:
                    break
            epoch += 1
            due = (state.step - last_eval) >= min(cfg.evaluation.eval_every, max_steps)
            if eval_batcher is not None and (due or state.step >= max_steps):
                last_eval = state.step
                agg: Dict[str, float] = {}
                n = 0
                last_out = None
                for _, ebatch in eval_batcher.epoch(0, cfg.evaluation.batch_size):
                    emetrics, last_out = eval_step(state, ebatch)
                    for k, v in emetrics.items():
                        agg[k] = agg.get(k, 0.0) + float(v)
                    n += 1
                    if n >= cfg.evaluation.num_eval_batches:
                        break
                if n:
                    logger.log(state.step, {k: v / n for k, v in agg.items()}, prefix="eval")
                    _log_eval_media(logger, state.step, cfg, last_out)
        ckpt.save(state.step, state)
    finally:
        logger.close()
    return state
