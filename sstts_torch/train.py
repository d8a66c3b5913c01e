"""Training: the port of `sstts/train.py` (43-996) for one device.

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

The device-resident corpus (`training.device_corpus_cache`, "auto" by
default): `build_device_corpus` puts the whole bucketed corpus on the
device once, as PCM16 rows or as features made there ("features", f32, or
"features_bf16"), within `device_corpus_budget_mb`; the cached step then
gathers its batch on the device from the row indices of
`cached_epoch_indices`, and the grouped step (`steps_per_call` = S > 1)
runs S such steps back to back with no host sync between them.  Both op
streams, their budget clamp and the resume skip are numpy copies of the
JAX package's, so one seed trains on the same batches in both packages.
A corpus over budget is fed from the host ("auto"; "on" raises), through
`_prefetch_to_device`: a worker thread builds the next batches and copies
them to the card from pinned memory on a side stream.  `training.debug_nans`
raises `FloatingPointError` at the first NaN a step makes (forward hooks on
every module, autograd's anomaly mode for the backward), as
`jax_debug_nans` does; it is synchronous by design.

`load_corpus` reads an LJSpeech-, Blizzard-Nancy- or CSS10-layout corpus
from disk, or makes the synthetic one.  `train` logs through
`sstts_torch.utils.logging.MetricsLogger`, in the JAX package's record
shape, with the eval media (alignment and mel images, Griffin-Lim audio of
the last eval batch).  Every architecture the reference's model accepts
trains here: at `compute_dtype="bfloat16"` the model computes in bf16
while the parameters, the losses, gradient clipping, Adam and the EMA stay
f32, as in the reference.

Meshes (`sstts/train.py:75-148, 231-356, 779-792`): `train` picks the
reference's layout, `model_parallel` ranks on the model axis and
gcd(batch_size, devices / model_parallel) on the data axis, and where that
is more than one device runs one process per rank
(`sstts_torch.parallel.mesh.launch`: NCCL on the card, gloo on the CPU).
Every rank builds the same full initial state and keeps its shard
(`create_state(mesh=)`); a step takes this rank's rows of the global batch
(for the resident corpus, its rows of each step's indices: the corpus is
whole on every rank), draws the prenets' keep masks for the global batch,
takes batch-norm statistics and loss denominators over the data group,
sums the gradients over it, clips by the global norm of the sharded and
replicated gradients and applies Adam (and the EMA) to its shard.  So a
mesh computes one device's step, to the order of its sums.  Rank 0 alone
writes `metrics.jsonl` and the checkpoints, which hold the gathered, full
tensors; the ranks of data row 0 run the evaluation on whole eval batches.
Unlike the reference, which keeps its Pallas kernels out of a GSPMD
program, each rank runs the kernels on its rows (ROADMAP C).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import itertools
import math
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from sstts_torch.checkpoint import CheckpointManager
from sstts_torch.config import Config
from sstts_torch.data import pipeline as pipeline_mod
from sstts_torch.data.ljspeech import load_metadata, train_eval_split
from sstts_torch.data.synthetic import make_utterances
from sstts_torch.dsp.ops import wav_to_features
from sstts_torch.model.losses import frame_mask_from_lengths, tacotron_loss
from sstts_torch.model.tacotron import Tacotron, init_state_dict
from sstts_torch.ops import gru as gru_ops
from sstts_torch.ops.teacher import resolve_teacher_impl
from sstts_torch.parallel import mesh as mesh_mod
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


def check_trainable(cfg: Config, device: Optional[torch.device] = None) -> None:
    """Raise for training settings this port does not implement (ROADMAP A
    names each); with a `device`, also check the BiGRUs' widths and
    resolve the teacher-forced scan there, before anything is launched (on
    the card a BiGRU wider than B3 takes, H above 5456, raises
    NotImplementedError; B6 takes any width)."""
    a, t = cfg.arch, cfg.training
    if device is not None:
        gru_ops.check_arch(a, device)
        resolve_teacher_impl(None, a, device)
    if t.model_parallel < 1:
        raise ValueError(f"training.model_parallel must be at least 1: {t.model_parallel}")
    if not 0.0 <= t.ema_decay < 1.0:
        raise ValueError(f"training.ema_decay must be in [0, 1): {t.ema_decay}")


def make_optimizer(cfg: Config, params) -> torch.optim.Adam:
    t = cfg.training
    return torch.optim.Adam(
        params, lr=t.learning_rate, betas=(t.adam_beta1, t.adam_beta2), eps=t.adam_eps
    )


def create_state(
    cfg: Config, seed: Optional[int] = None, device=None, mesh: Optional[mesh_mod.Mesh] = None
) -> TrainState:
    """A seeded random init (`init_state_dict`) on `device` (None: the card)
    with fresh Adam moments.  On a `mesh` every rank builds the same full
    init and keeps its shard (`mesh.shard_model`)."""
    dev = resolve_device(device)
    check_trainable(cfg, dev)
    model = Tacotron(cfg.arch, cfg.dataset)
    model.load_state_dict(
        init_state_dict(cfg.arch, cfg.dataset, cfg.training.seed if seed is None else seed)
    )
    if mesh is not None:
        mesh_mod.shard_model(model, mesh)
    model.to(dev)
    ema = None
    if cfg.training.ema_decay > 0.0:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(0, model, make_optimizer(cfg, model.parameters()), ema)


def _to_device(batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}


def _pinned_to(dev: torch.device, *arrays) -> List[torch.Tensor]:
    """Host numpy arrays as tensors on `dev`: to the card from pinned memory
    without waiting for it (a pageable copy makes the host wait)."""
    if dev.type != "cuda":
        return [torch.as_tensor(a) for a in arrays]
    return [
        torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(dev, non_blocking=True)
        for a in arrays
    ]


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


def _floats(out) -> Iterator[torch.Tensor]:
    """The floating-point tensors of a module's output (nested tuples,
    lists and dicts)."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _floats(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _floats(o)


@contextlib.contextmanager
def _debug_nans(model: torch.nn.Module, step: int):
    """`jax_debug_nans` for one step: FloatingPointError at the first NaN.
    Forward hooks on every module check its outputs (the GRU and
    teacher-scan kernels' among them); autograd's anomaly mode checks every
    backward function's outputs (B3's and B6's backward too), and its
    RuntimeError is raised as FloatingPointError.  Each check waits for the
    device."""

    def hook(name, module, args, out):
        if any(bool(torch.isnan(t).any()) for t in _floats(out)):
            raise FloatingPointError(
                f"NaN in the output of module {name or '<model>'} "
                f"({type(module).__name__}) at step {step}"
            )

    handles = [
        m.register_forward_hook(functools.partial(hook, n)) for n, m in model.named_modules()
    ]
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            yield
    except RuntimeError as e:
        if "returned nan values" not in str(e):
            raise
        raise FloatingPointError(f"{e} (step {step})") from e
    finally:
        for h in handles:
            h.remove()


def _check_nan(what: str, tensors, step: int) -> None:
    if any(bool(torch.isnan(t).any()) for t in tensors):
        raise FloatingPointError(f"NaN in {what} at step {step}")


def _make_step_body(cfg: Config, from_features: bool = False):
    """(state, batch of tensors on the state's device) -> metrics, updating
    `state` in place.  `from_features` takes "linear"/"mel" from the batch
    (a feature-format device corpus, cast to f32) instead of "samples".  On
    a mesh (the state's model's) the batch is this rank's rows and the
    metrics are the global batch's."""
    check_trainable(cfg)
    t = cfg.training
    sched = lr_schedule(cfg)

    def step_body(state: TrainState, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model = state.model
        mesh = model.mesh
        dev = _device_of(state)
        gen = torch.Generator(device=dev).manual_seed(((t.seed + 1) << 32) + state.step)
        rows = group = None
        if mesh is not None:
            n = b["char_ids"].shape[0]
            rows, group = (mesh.data_index * n, mesh.shape["data"] * n), mesh.data_group
        model.train()
        guard = _debug_nans(model, state.step) if t.debug_nans else contextlib.nullcontext()
        with exact_f32(dev), guard:
            if from_features:
                linear_gt, mel_gt = b["linear"].float(), b["mel"].float()
                frame_mask = frame_mask_from_lengths(b["n_frames"], mel_gt.shape[1])
            else:
                linear_gt, mel_gt, frame_mask = _targets(b, cfg)
            out = model(b["char_ids"], mel_gt, frame_mask, gen, rows)
            loss, metrics = tacotron_loss(
                out, mel_gt, linear_gt, b["loss_frames"], cfg.arch, cfg.dataset,
                text_lengths=b["text_len"], group=group,
            )
            if t.debug_nans:
                _check_nan("the loss", [loss], state.step)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            named = list(model.named_parameters())
            params = [p for _, p in named]
            for p in params:  # optax updates every leaf, a zero gradient too
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if mesh is None:
                g_norm = global_norm([p.grad for p in params])
            else:
                mesh_mod.reduce_gradients(params, mesh)
                g_norm = mesh_mod.global_grad_norm(
                    [(n, p.grad) for n, p in named], mesh, global_norm
                )
            # optax.clip_by_global_norm: g / ||g|| * max_norm once ||g|| >= max_norm.
            keep = g_norm < t.grad_clip_norm
            for p in params:
                p.grad = torch.where(keep, p.grad, p.grad / g_norm * t.grad_clip_norm)
            lr = sched(state.step)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            state.optimizer.step()
            if t.debug_nans:
                _check_nan("the gradient norm", [g_norm], state.step)
                _check_nan("the updated parameters", params, state.step)
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

    return step_body


def _local(state: TrainState, arrays):
    """This rank's rows of global arrays on a mesh (`P("data")`), else the
    arrays."""
    mesh = state.model.mesh
    return arrays if mesh is None else mesh_mod.shard_batch(arrays, mesh)


def make_train_step(cfg: Config):
    """(state, batch) -> metrics, updating `state` in place.  `batch` holds
    the `pipeline.make_batch` fields as numpy arrays or tensors: the global
    batch, of which a mesh's rank takes its rows."""
    body = _make_step_body(cfg)

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        return body(state, _to_device(_local(state, batch), _device_of(state)))

    return train_step


_CORPUS_KEYS = ("char_ids", "text_len", "samples", "n_frames", "loss_frames")
_CORPUS_KEYS_FEATURES = (
    "char_ids", "text_len", "linear", "mel", "n_frames", "loss_frames"
)
#: Rows per upload + featurize chunk when building a feature-format corpus:
#: it bounds the build's device transient (a chunk's PCM16, its STFT and
#: its features).  Tests shrink it to cover the chunked path on small
#: corpora.
_FEATURIZE_CHUNK_ROWS = 256


def corpus_keys(cfg: Config):
    fmt = cfg.training.device_corpus_format
    if fmt in ("features", "features_bf16"):
        return _CORPUS_KEYS_FEATURES
    if fmt == "pcm16":
        return _CORPUS_KEYS
    raise ValueError(f"unknown device_corpus_format: {fmt!r}")


def _gather(corpus: Dict[str, torch.Tensor], keys, idx: torch.Tensor, valid: torch.Tensor):
    """One batch gathered on the corpus's device; rows with valid == 0
    (epoch-tail fill) get loss_frames 0, so they add no loss."""
    b = {k: corpus[k].index_select(0, idx) for k in keys}
    lf = b["loss_frames"]
    b["loss_frames"] = torch.where(valid > 0, lf, torch.zeros_like(lf))
    return b


def make_cached_train_step(cfg: Config):
    """The train step over the device-resident corpus:
    (state, corpus_bucket, idx (B,), valid (B,)) -> metrics, where
    `corpus_bucket` is one bucket's tensors (`build_device_corpus`), `idx`
    selects its rows (gathered on the device) and `valid` zeros the loss of
    epoch-tail fill rows.  `idx`/`valid` come as host arrays and reach the
    card from pinned memory without a host wait."""
    keys = corpus_keys(cfg)
    body = _make_step_body(cfg, from_features="linear" in keys)

    def cached_step(state: TrainState, corpus, idx, valid) -> Dict[str, torch.Tensor]:
        iv = _local(state, {"idx": idx, "valid": valid})
        idx_d, valid_d = _pinned_to(_device_of(state), iv["idx"], iv["valid"])
        return body(state, _gather(corpus, keys, idx_d, valid_d))

    return cached_step


def make_grouped_train_step(cfg: Config):
    """S train steps in one call (`training.steps_per_call`):
    (state, corpus_bucket, idxs (S, B), valids (S, B)) -> metrics, each
    stacked to (S,) ("lr", known on the host, stays there).  Each step
    gathers its own rows and seeds its dropout from its own step number, so
    the call equals S cached steps; nothing waits for the card between
    them.  A mesh's rank takes its columns of `idxs` and `valids`."""
    keys = corpus_keys(cfg)
    body = _make_step_body(cfg, from_features="linear" in keys)

    def grouped_step(state: TrainState, corpus, idxs, valids) -> Dict[str, torch.Tensor]:
        mesh = state.model.mesh
        if mesh is not None:  # P(None, "data")
            cols = mesh.rows(idxs.shape[1])
            idxs, valids = idxs[:, cols], valids[:, cols]
        idxs_d, valids_d = _pinned_to(_device_of(state), idxs, valids)
        ms = [body(state, _gather(corpus, keys, idxs_d[i], valids_d[i]))
              for i in range(idxs_d.shape[0])]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return grouped_step


def _featurize_rows(host: np.ndarray, cfg: Config, dev: torch.device, dtype):
    """(linear, mel) of a bucket's PCM16 rows, made on `dev` in chunks of
    `_FEATURIZE_CHUNK_ROWS` rows into buffers of the storage dtype.  The
    chunk shape is fixed: the last chunk re-covers rows already written
    (featurization is deterministic, so the overlap rewrites equal
    values)."""
    n = host.shape[0]
    rows = min(_FEATURIZE_CHUNK_ROWS, n)
    starts = list(range(0, n - rows + 1, rows))
    if starts[-1] + rows < n:
        starts.append(n - rows)
    bufs = None
    for off in starts:
        chunk = torch.from_numpy(host[off : off + rows]).to(dev)
        with torch.no_grad(), exact_f32(dev):
            feats = wav_to_features(
                chunk.float() * (1.0 / 32767.0), cfg.dataset, cfg.training.feature_fft_impl
            )
        if bufs is None:
            bufs = [torch.empty((n, *f.shape[1:]), dtype=dtype, device=dev) for f in feats]
        for buf, f in zip(bufs, feats):
            buf[off : off + rows] = f
        del chunk, feats
    return bufs


def build_device_corpus(cfg: Config, utts, batcher=None, device=None):
    """Put the whole bucketed corpus on `device` (None: the card) once.

    Returns (({bucket: {field: tensor (N_b, ...)}}, {bucket: N_b}), None),
    or (None, reason) over the `device_corpus_budget_mb` budget or when no
    utterance fits a bucket.  Each utterance goes through
    `pipeline.make_batch` alone, at the bucket shape the host `Batcher`
    would give it, so cached and host-fed steps see byte-equal rows.  The
    running total is checked against the budget as rows accumulate (a
    feature format counts its features in place of the samples).  The
    feature formats keep linear and mel, made on the device
    (`_featurize_rows`), in f32 or bf16, instead of the samples.
    """
    dev = resolve_device(device)
    if batcher is None:
        batcher = pipeline_mod.Batcher(utts, cfg)
    shapes = pipeline_mod.frame_bucket_shapes(cfg)
    hop = cfg.dataset.hop_len
    budget = cfg.training.device_corpus_budget_mb * (1 << 20)
    as_features = corpus_keys(cfg) is _CORPUS_KEYS_FEATURES
    feat_dtype = (
        torch.bfloat16 if cfg.training.device_corpus_format == "features_bf16" else torch.float32
    )
    feat_row_bytes = {
        b: feat_dtype.itemsize * fr * (cfg.dataset.n_linear + cfg.dataset.n_mels)
        for b, (_, fr) in enumerate(shapes)
    }
    rows: Dict[int, list] = {}
    total_bytes = 0
    for u, ids in batcher.examples:
        audio = batcher.audio(u)
        nf = 1 + len(audio) // hop
        bucket = pipeline_mod.assign_bucket(len(ids), nf, shapes)
        if bucket < 0:
            continue
        lt, fr = shapes[bucket]
        row = pipeline_mod.make_batch([(ids, audio)], lt, fr, cfg)
        total_bytes += sum(
            feat_row_bytes[bucket] if as_features and k == "samples" else v.nbytes
            for k, v in row.items()
        )
        if total_bytes > budget:
            return None, (
                f"corpus exceeds the "
                f"{cfg.training.device_corpus_budget_mb} MiB device budget "
                f"(aborted after {sum(map(len, rows.values())) + 1} "
                "utterances)"
            )
        rows.setdefault(bucket, []).append(row)
    if not rows:
        return None, "no utterance fits the configured buckets"
    corpus: Dict[int, Dict[str, torch.Tensor]] = {}
    counts: Dict[int, int] = {}
    for bucket, items in sorted(rows.items()):
        on_dev = {}
        for k in list(items[0].keys()):
            host = np.concatenate([r.pop(k) for r in items], axis=0)
            if as_features and k == "samples":
                on_dev["linear"], on_dev["mel"] = _featurize_rows(host, cfg, dev, feat_dtype)
            else:
                on_dev[k] = torch.from_numpy(host).to(dev)
            del host
        corpus[bucket] = on_dev
        counts[bucket] = len(items)
    return (corpus, counts), None


def _bucket_batches(rng, n: int, batch_size: int):
    """One bucket's epoch as [(idx (B,) int32, valid (B,) f32)]: every row
    exactly once; the remainder batch repeats rows with valid=0 (zero loss
    contribution).  Shared by the single-step and grouped epoch generators
    so their coverage contracts cannot diverge."""
    perm = rng.permutation(n)
    out = []
    for start in range(0, n, batch_size):
        chunk = perm[start : start + batch_size]
        valid = np.ones(batch_size, np.float32)
        if len(chunk) < batch_size:
            valid[len(chunk) :] = 0.0
            fill = chunk[np.arange(batch_size - len(chunk)) % len(chunk)]
            chunk = np.concatenate([chunk, fill])
        out.append((chunk.astype(np.int32), valid))
    return out


def cached_epoch_indices(counts: Dict[int, int], batch_size: int, seed: int):
    """Yield (bucket, idx (B,) int32, valid (B,) f32) covering each bucket
    once, shuffled; remainder batches repeat rows with valid=0 (zero loss)."""
    rng = np.random.default_rng(seed)
    order = []
    for bucket, n in sorted(counts.items()):
        order.extend((bucket, c, v) for c, v in _bucket_batches(rng, n, batch_size))
    rng.shuffle(order)
    yield from order


def grouped_epoch_indices(
    counts: Dict[int, int], batch_size: int, steps_per_call: int, seed: int
):
    """cached_epoch_indices grouped for the multi-step call: yields
    ("grouped", bucket, idxs (S, B), valids (S, B)) for full same-bucket
    runs of S batches, and ("single", bucket, idx (B,), valid (B,)) for
    each bucket's per-epoch remainder.  Same coverage contract: every
    corpus row appears exactly once per epoch (fill rows carry valid=0)."""
    rng = np.random.default_rng(seed)
    S = steps_per_call
    ops = []
    for bucket, n in sorted(counts.items()):
        chunks = _bucket_batches(rng, n, batch_size)
        n_full = len(chunks) - len(chunks) % S
        for i in range(0, n_full, S):
            grp = chunks[i : i + S]
            ops.append((
                "grouped", bucket,
                np.stack([c for c, _ in grp]),
                np.stack([v for _, v in grp]),
            ))
        for c, v in chunks[n_full:]:
            ops.append(("single", bucket, c, v))
    rng.shuffle(ops)
    yield from ops


def _clamp_grouped_ops(ops, budget: int):
    """Decompose grouped ops into singles where a full group would overshoot
    the remaining step budget, and stop once the budget is covered, so
    `train(max_steps=N)` lands exactly on N for any steps_per_call."""
    used = 0
    for op in ops:
        if used >= budget:
            return
        if op[0] == "grouped" and used + len(op[2]) > budget:
            _, bucket, idxs, valids = op
            for i in range(len(idxs)):
                yield ("single", bucket, idxs[i], valids[i])
                used += 1
                if used >= budget:
                    return
            continue
        used += len(op[2]) if op[0] == "grouped" else 1
        yield op


def _skip_epoch_steps(ops, n_steps: int):
    """Drop the first `n_steps` training steps of an epoch's op stream, so a
    resumed run continues the data order where the interrupted one stopped.
    A resume offset can land inside a grouped op (the interrupted run's
    budget tail ran as singles, while the regenerated epoch stream is not
    clamped): the straddling op is split and its un-run tail re-emitted as
    single-step ops."""
    consumed = 0
    for op in ops:
        if consumed >= n_steps:
            yield op
            continue
        ns = len(op[2]) if op[0] == "grouped" else 1
        consumed += ns
        if consumed > n_steps:
            # Only a grouped op (ns > 1) can straddle the offset.
            tail = consumed - n_steps
            _, bucket, idxs, valids = op
            print(
                f"[resume] grouped op straddles the resume offset: "
                f"re-emitting {tail} of its {ns} steps as singles",
                flush=True,
            )
            for i in range(ns - tail, ns):
                yield ("single", bucket, idxs[i], valids[i])


_END = object()


def _read_ahead(items: Iterator, put: Callable, depth: int) -> Iterator:
    """put(item) for each item, in order, computed by one worker thread that
    pulls the items itself and keeps up to `depth` + 1 results ahead of the
    consumer.  Closing the generator cancels what has not started and waits
    for the worker."""
    it = iter(items)

    def fetch():  # one worker: the pulls are serial and in order
        item = next(it, _END)
        return _END if item is _END else put(item)

    executor = ThreadPoolExecutor(max_workers=1)
    try:
        queue = collections.deque(executor.submit(fetch) for _ in range(depth + 1))
        while True:
            result = queue.popleft().result()
            if result is _END:
                return
            queue.append(executor.submit(fetch))
            yield result
    finally:
        executor.shutdown(wait=True, cancel_futures=True)


def _prefetch_to_device(batches: Iterator, device, depth: int = 2) -> Iterator:
    """(bucket, host batch) pairs -> (bucket, batch on `device`), `depth`
    batches ahead of the consumer.  On the card a worker thread builds the
    next batches, copies them into pinned memory and from there to the card
    on a side stream; the consumer's stream waits on that copy's event and
    each tensor is recorded on it, so the allocator keeps it until the
    consumer's work is done.  On the CPU the batches pass through as they
    are."""
    dev = torch.device(device)
    if dev.type != "cuda":
        yield from batches
        return
    side = torch.cuda.Stream(dev)

    def put(item):
        bucket, batch = item
        with torch.cuda.device(dev), torch.cuda.stream(side):
            out = dict(zip(batch, _pinned_to(dev, *batch.values())))
            done = torch.cuda.Event()
            done.record(side)
        return bucket, out, done

    for bucket, out, done in _read_ahead(batches, put, depth):
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(done)
        for v in out.values():
            v.record_stream(stream)
        yield bucket, out


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


class _NoLogger:
    """The metrics logger of a rank that writes none (not rank 0)."""

    def log(self, *args, **kw) -> None:
        pass

    def close(self) -> None:
        pass


def mesh_layout(cfg: Config, n_devices: int):
    """(data, model) by the reference's rule (`sstts/train.py:779-792`):
    `model_parallel` must divide the devices, and the data axis is
    gcd(batch_size, devices / model_parallel)."""
    n_model = max(cfg.training.model_parallel, 1)
    if n_devices % n_model:
        raise ValueError(
            f"training.model_parallel={n_model} does not divide the "
            f"{n_devices} visible devices"
        )
    return math.gcd(cfg.training.batch_size, n_devices // n_model), n_model


# A mesh's training run has no deadline; each of its collectives waits at
# most this long, well above the longest wait of a rank: the other data rows
# while data row 0 evaluates, or every rank while rank 0 writes a checkpoint.
COLLECTIVE_TIMEOUT_S = 1800.0


def train(
    cfg: Config,
    workdir: str | Path = "runs/default",
    max_steps: Optional[int] = None,
    device=None,
    log_every: Optional[int] = None,
    n_devices: Optional[int] = None,
) -> TrainState:
    """Training driver (`sstts/train.py:train`, `_train_loop`): the
    device-resident corpus where `device_corpus_cache` allows and it fits
    its budget, else host-fed batches -> train steps (S at a time with
    `steps_per_call`) -> metrics (`workdir/metrics.jsonl`), checkpoints
    every `checkpoint_every` steps and at the end, and an evaluation at
    most every `eval_every` steps.  Log and checkpoint cadences fire where
    a call crosses their thresholds, so they behave alike for any S.
    Resumes from the newest checkpoint under `workdir`, continuing the data
    order; lands exactly on `max_steps`.

    The layout is `mesh_layout` over `n_devices` (None: every visible GPU
    on the card, one device on the CPU).  One device trains in this
    process; more train in one process per rank (`mesh.launch`), and the
    returned state is then the final checkpoint, whole, on `device`."""
    dev = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    n_data, n_model = mesh_layout(cfg, n_devices)
    if n_data * n_model == 1:
        return _train_loop(cfg, Path(workdir), max_steps, dev, log_every, None)
    check_trainable(cfg, dev)
    mesh_mod.launch(
        _train_rank, n_data * n_model, cfg, str(workdir), max_steps, log_every,
        n_data, n_model, dev.type, device=dev.type,
        timeout=None, collective_timeout=COLLECTIVE_TIMEOUT_S,
    )
    state = create_state(cfg, device=dev)
    CheckpointManager(cfg, workdir).restore_latest(state)
    return state


def _train_rank(cfg, workdir, max_steps, log_every, n_data, n_model, device_type) -> int:
    """One rank of a mesh's training run (a `mesh.launch` worker)."""
    mesh = mesh_mod.make_mesh(data_parallel=n_data, model_parallel=n_model)
    dev = torch.device("cuda", mesh.rank) if device_type == "cuda" else torch.device("cpu")
    return _train_loop(cfg, Path(workdir), max_steps, dev, log_every, mesh).step


def _train_loop(cfg: Config, workdir: Path, max_steps, dev: torch.device, log_every,
                mesh: Optional[mesh_mod.Mesh]) -> TrainState:
    workdir.mkdir(parents=True, exist_ok=True)
    t = cfg.training
    max_steps = max_steps or t.max_steps
    log_every = log_every or t.summary_every
    lead = mesh is None or mesh.rank == 0
    evaluates = mesh is None or mesh.data_index == 0
    train_utts, eval_utts = load_corpus(cfg)
    batcher = pipeline_mod.Batcher(train_utts, cfg)
    eval_batcher = pipeline_mod.Batcher(eval_utts, cfg) if eval_utts and evaluates else None
    state = create_state(cfg, device=dev, mesh=mesh)
    if lead:  # rank 0 writes the directory's fingerprint before the others read it
        ckpt = CheckpointManager(cfg, workdir)
    if mesh is not None:
        torch.distributed.barrier()
    if not lead:
        ckpt = CheckpointManager(cfg, workdir)
    if ckpt.restore_latest(state) is not None:
        print(f"resumed from checkpoint at step {state.step}", flush=True)
    eval_step = make_eval_step(cfg)

    corpus = counts = None
    if t.device_corpus_cache != "off":
        built, reason = build_device_corpus(cfg, train_utts, batcher=batcher, device=dev)
        if built is not None:
            corpus, counts = built
            print(
                f"device corpus cache: {sum(counts.values())} utterances resident in "
                f"HBM ({len(counts)} buckets)", flush=True,
            )
        else:
            if t.device_corpus_cache == "on":
                raise ValueError(f"device_corpus_cache=on but {reason}")
            print(f"device corpus cache disabled: {reason}", flush=True)
    if corpus is not None:
        cached_step = make_cached_train_step(cfg)
    else:
        train_step = make_train_step(cfg)

    step = state.step
    # Resume continues the data order (epoch seeds are seed + epoch): the
    # epoch and the mid-epoch offset follow from the restored step.
    epoch = skip_steps = 0
    if step > 0:
        if corpus is not None:
            spe = sum(-(-n // t.batch_size) for n in counts.values())
        else:
            spe = batcher.batches_per_epoch(t.batch_size)
        if spe > 0:
            epoch, skip_steps = divmod(step, spe)
            if skip_steps:
                print(
                    f"resume: continuing data order at epoch {epoch} "
                    f"(+{skip_steps} of {spe} steps)", flush=True,
                )
    S = max(1, int(t.steps_per_call)) if corpus is not None else 1
    if corpus is None and int(t.steps_per_call) > 1:
        print(
            f"steps_per_call={t.steps_per_call} needs the "
            "device corpus (gathers run on device); falling back to "
            "single-step dispatch because the corpus is host-fed",
            flush=True,
        )
    grouped_step = make_grouped_train_step(cfg) if S > 1 else None
    last_eval, last_log, t_last = step, step, time.time()
    logger = MetricsLogger(workdir) if lead else _NoLogger()
    try:
        while step < max_steps:
            if corpus is not None and S > 1:
                # Skip before clamping: the skipped steps ran in the
                # interrupted run and do not count against the budget.
                ops = _clamp_grouped_ops(
                    _skip_epoch_steps(
                        grouped_epoch_indices(counts, t.batch_size, S, t.seed + epoch),
                        skip_steps,
                    ),
                    max_steps - step,
                )
            elif corpus is not None:
                ops = _skip_epoch_steps(
                    (("single", bucket, idx, valid) for bucket, idx, valid in
                     cached_epoch_indices(counts, t.batch_size, t.seed + epoch)),
                    skip_steps,
                )
            else:
                # Skipped batches are dropped before the prefetch: they never
                # reach the card.
                ep = itertools.islice(
                    batcher.epoch(t.seed + epoch, t.batch_size), skip_steps, None
                )
                ops = (("host", None, batch, None)
                       for _, batch in _prefetch_to_device(ep, dev))
            was_resume_epoch = skip_steps > 0
            skip_steps = 0
            epoch_batches = 0
            for kind, bucket, a, b in ops:
                epoch_batches += 1
                if kind == "host":
                    metrics = train_step(state, a)
                elif kind == "single":
                    metrics = cached_step(state, corpus[bucket], a, b)
                else:
                    metrics = grouped_step(state, corpus[bucket], a, b)
                ns = state.step - step
                step = state.step
                if lead and step // log_every != (step - ns) // log_every:
                    host = {k: float(v.reshape(-1)[-1]) for k, v in metrics.items()}
                    now = time.time()
                    host["steps_per_s"] = (step - last_log) / max(now - t_last, 1e-9)
                    last_log, t_last = step, now
                    logger.log(step, host)
                if step // t.checkpoint_every != (step - ns) // t.checkpoint_every:
                    ckpt.save(step, state)
                if step >= max_steps:
                    break
            if epoch_batches == 0 and not was_resume_epoch:
                # A resume epoch can be consumed by the fast-forward; only a
                # fresh epoch that yields nothing means broken buckets.
                raise ValueError(
                    "the epoch produced zero batches: every utterance exceeded "
                    "the configured buckets (text_buckets/frame_buckets) or the "
                    "corpus is empty — widen the buckets or check the dataset"
                )
            epoch += 1
            due = (step - last_eval) >= min(cfg.evaluation.eval_every, max_steps)
            if eval_batcher is not None and (due or step >= max_steps):
                last_eval = step
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
                if n and lead:
                    logger.log(step, {k: v / n for k, v in agg.items()}, prefix="eval")
                    _log_eval_media(logger, step, cfg, last_out)
        ckpt.save(step, state)
    finally:
        logger.close()
    return state
