"""Centralized hyperparameters: a verbatim copy of `sstts/config.py`.

The PyTorch port keeps its own copy so that it never imports the JAX
package; `Config().fingerprint()` therefore agrees between the two
(tests/test_torch_imports.py holds that).  The measurement notes in the
field comments below describe the JAX reference on its TPU, not this port.
Inference knobs the port reads differently are documented in
`sstts_torch.synthesize`.

Mirrors the reference's hparams split (`tacotron/params/{architecture,dataset,
training,evaluation,inference}.py` — see SURVEY.md §2.4; the reference mount was
empty, so the canonical numeric values come from the Tacotron paper (arXiv
1703.10135, Table 1) + LJSpeech conventions, as pinned by SURVEY.md).

Design: frozen dataclasses.  Everything downstream reads only these objects, so
all array shapes are static once a config is constructed — a requirement for
XLA's trace-once/compile-once model.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def ms_to_samples(ms: float, sample_rate: int) -> int:
    """Convert a duration in milliseconds to a sample count (floor).

    Matches the reference's `audio/conversion.py:ms_to_samples` semantics
    (``int(sample_rate * ms / 1000)``).
    """
    return int(sample_rate * ms / 1000.0)


@dataclass(frozen=True)
class DatasetConfig:
    """Audio + corpus hyperparameters (reference: `tacotron/params/dataset.py`)."""

    dataset: str = "ljspeech"
    dataset_dir: str = "data/LJSpeech-1.1"
    #: LJSpeech native sample rate.
    sample_rate: int = 22050
    #: FFT size -> n_fft // 2 + 1 = 1025 linear bins.
    n_fft: int = 2048
    #: STFT window length in ms (Tacotron: 50 ms frame length).
    win_len_ms: float = 50.0
    #: STFT hop in ms (Tacotron: 12.5 ms frame shift).
    win_hop_ms: float = 12.5
    #: Number of mel bands.
    n_mels: int = 80
    #: Mel filterbank frequency range (Slaney-style filterbank, librosa default).
    mel_fmin: float = 0.0
    mel_fmax: float = 11025.0
    #: Pre-emphasis coefficient.
    preemphasis: float = 0.97
    #: dB reference level subtracted before normalization.
    ref_level_db: float = 20.0
    #: dB floor used for [0, 1] normalization.
    min_level_db: float = -100.0
    #: Silence trimming threshold in dB below peak.
    trim_top_db: float = 60.0
    #: Fraction of the corpus held out for evaluation.
    eval_fraction: float = 0.01
    #: Maximum text length (chars, post-normalization) kept in the corpus.
    max_text_len: int = 256
    #: Maximum mel frames kept in the corpus (training-time cap).
    max_frames: int = 1024
    #: Utterance count for the synthetic corpus (dataset="synthetic").
    synthetic_size: int = 256
    #: Directory of the offline pre-computation cache (empty = disabled).
    #: Built by `python -m sstts.cli precompute`; see data/features_cache.py.
    cache_dir: str = ""
    #: Resample corpus audio to `sample_rate` at load time instead of
    #: raising on mismatch (host-side polyphase sinc, sstts.dsp.resample;
    #: for 16 kHz corpora like Blizzard-Nancy / CSS10).
    resample_on_load: bool = False
    #: Extra characters appended to the text charset (e.g.
    #: ``("äöü",)`` for the thesis's German corpus — SURVEY.md §2.3).
    #: Appending AFTER the base charset keeps every base character id
    #: stable, so the LJSpeech default charset (and its checkpoints) is
    #: unchanged; a non-empty value grows the embedding table and therefore
    #: participates in the checkpoint fingerprint.
    extra_chars: Tuple[str, ...] = ()
    #: Expand digits to English words during text normalization ("1876" →
    #: "eighteen seventy six"; scope documented on `text.Charset.normalize`).
    #: LJSpeech's normalized transcripts spell numbers out, so serving raw
    #: digit ids would be out-of-distribution; default on keeps training and
    #: serving tokenization consistent.  The charset itself is unchanged
    #: (digits stay in the table), so this is fingerprint-neutral.
    expand_numbers: bool = True

    def __post_init__(self) -> None:
        # Fail at construction with a clear message instead of deep inside
        # the STFT window construction (np.pad with a negative width): the window
        # must fit the FFT frame, and the hop must not exceed the window.
        if self.win_len > self.n_fft:
            raise ValueError(
                f"win_len_ms={self.win_len_ms} at sample_rate="
                f"{self.sample_rate} gives win_len={self.win_len} samples "
                f"> n_fft={self.n_fft}; raise n_fft or lower "
                "win_len_ms/sample_rate"
            )
        if self.hop_len < 1 or self.hop_len > self.win_len:
            raise ValueError(
                f"win_hop_ms={self.win_hop_ms} at sample_rate="
                f"{self.sample_rate} gives hop_len={self.hop_len}; must be "
                f"in [1, win_len={self.win_len}]"
            )

    @property
    def win_len(self) -> int:
        return ms_to_samples(self.win_len_ms, self.sample_rate)

    @property
    def hop_len(self) -> int:
        return ms_to_samples(self.win_hop_ms, self.sample_rate)

    @property
    def n_linear(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class ArchitectureConfig:
    """Model hyperparameters (reference: `tacotron/params/architecture.py`).

    Defaults follow Tacotron (arXiv 1703.10135) Table 1.
    """

    vocab_size: int = 0  # filled in from the text frontend; 0 = use charset size
    embedding_dim: int = 256
    # Pre-net (encoder + decoder): FC-256-ReLU -> drop -> FC-128-ReLU -> drop.
    prenet_units: Tuple[int, ...] = (256, 128)
    prenet_dropout: float = 0.5
    #: Keep pre-net dropout active at inference (Tacotron-1 behaviour).
    prenet_dropout_at_inference: bool = True
    # Encoder CBHG.
    encoder_bank_k: int = 16
    encoder_bank_channels: int = 128
    encoder_proj_channels: Tuple[int, int] = (128, 128)
    encoder_highway_layers: int = 4
    encoder_highway_units: int = 128
    encoder_gru_units: int = 128  # per direction -> memory dim 256
    #: Run each conv bank as one wide fused conv (single MXU GEMM) instead
    #: of K narrow convs; same parameters either way (modules.Conv1dBank).
    #: Measured on v5e: the fused form's 2x FLOP padding waste slightly
    #: outweighs the launch savings at Tacotron shapes (40 vs 35.5 ms
    #: synthesis prepare; train step within noise), so the default is the
    #: exact K-conv form.  The fused path stays available and tested.
    fused_conv_bank: bool = False
    #: Rematerialize the teacher-forced decoder scan body in the backward
    #: pass (`flax.linen.remat` around the per-step cell): activation HBM
    #: for the longest scan in the train step drops from O(steps x cell
    #: internals) to O(steps x carry) at the cost of recomputing the cell
    #: forward during backprop — the standard TPU FLOPs-for-HBM trade for
    #: fitting bigger batches/corpora (e.g. steps_per_call>1 next to a
    #: large resident corpus).  Identical loss/grads (tested); checkpoint-
    #: compatible (excluded from the fingerprint).
    remat_decoder: bool = False
    #: Unroll factor for the teacher-forced decoder scan (lax.scan unroll):
    #: >1 replicates the step body per loop iteration so XLA can pipeline
    #: across steps — targets the scan BACKWARD, where per-iteration
    #: overhead dominates (fwd 0.42 vs fwd+bwd 4.49 ms at b=32, S=80).
    #: Numerically identical (tested); checkpoint-compatible (excluded
    #: from the fingerprint).  Step counts ship padded to bucket sizes,
    #: which are multiples of any small unroll.
    decoder_scan_unroll: int = 1
    # Decoder.
    #: "bahdanau" (reference default) or "local_luong" (thesis variant).
    attention_type: str = "bahdanau"
    local_attention_window: int = 16
    attention_units: int = 256
    attention_gru_units: int = 256
    decoder_gru_layers: int = 2
    decoder_gru_units: int = 256
    #: Reduction factor: mel frames emitted per decoder step.
    reduction_factor: int = 5
    # Post-processing CBHG.
    post_bank_k: int = 8
    post_bank_channels: int = 128
    post_proj_channels: Tuple[int, int] = (256, 80)
    post_highway_layers: int = 4
    post_highway_units: int = 128
    post_gru_units: int = 128
    #: Weight of the linear-spectrogram L1 term focused below `loss_low_freq_hz`.
    loss_low_freq_weight: float = 0.5
    loss_low_freq_hz: float = 3000.0
    #: Weight on the stop-token BCE (rebuild addition — SURVEY.md §2.2).
    stop_token_weight: float = 1.0
    #: Guided-attention diagonal prior (Tachibana et al. 2017), opt-in
    #: extension over the reference: 0.0 disables (default).
    guided_attention_weight: float = 0.0
    guided_attention_sigma: float = 0.2
    #: Parameter / activation dtype for the compute path ("bfloat16" | "float32").
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class TrainingConfig:
    """Training hyperparameters (reference: `tacotron/params/training.py`)."""

    batch_size: int = 32
    learning_rate: float = 1e-3
    #: Step-decay schedule: lr * decay_rate ** (step / decay_steps).
    lr_decay_steps: int = 50000
    lr_decay_rate: float = 0.5
    lr_min: float = 1e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip_norm: float = 1.0
    #: Exponential moving average (Polyak averaging) of the parameters,
    #: maintained inside the jitted step when > 0 (0 disables — the
    #: default; nothing about the state tree or checkpoint changes).
    #: When enabled the TrainState carries an `ema_params` tree updated as
    #: ema = decay*ema + (1-decay)*params each step; evaluation/serving
    #: select it with `inference.use_ema`.  Restore adapts both ways: an
    #: EMA run resuming a pre-EMA checkpoint seeds ema from the restored
    #: params; a non-EMA run reading an EMA checkpoint keeps the stored
    #: ema available (checkpoint.py).  Training-section field: never part
    #: of the checkpoint fingerprint.
    ema_decay: float = 0.0
    max_steps: int = 500000
    checkpoint_every: int = 5000
    summary_every: int = 100
    keep_checkpoints: int = 5
    checkpoint_dir: str = "checkpoints"
    #: Bucket boundaries for padded text length (static shapes per bucket).
    text_buckets: Tuple[int, ...] = (64, 128, 192, 256)
    #: Bucket boundaries for padded decoder-step count per text bucket.
    frame_buckets: Tuple[int, ...] = (256, 512, 768, 1024)
    #: Compute features (STFT/mel/dB) on device inside the train step.
    on_device_features: bool = True
    #: FFT implementation for the training/eval feature extraction
    #: (`dsp.ops.wav_to_features`): "default" (XLA FFT, the golden-tested
    #: oracle path) or "dft_default"/"dft_high"/"dft_highest" — |STFT| as
    #: two direct support-reduced window-folded DFT GEMMs on the MXU
    #: (46% less contraction work at the default hparams; the Griffin-Lim
    #: loop's formulation applied to the analysis side).  Precision ladder:
    #: dft_highest ~ f32-exact, dft_high ~1e-6 feature error, dft_default
    #: one bf16 pass.  Training-only perf knob: never part of the
    #: checkpoint fingerprint; the offline feature cache and the golden
    #: DSP tests always use "default".
    feature_fft_impl: str = "default"
    #: Keep the whole bucketed PCM16 corpus resident in device HBM and
    #: gather batches on device ("auto" = when it fits the budget below;
    #: "on" = require it; "off" = host feeding).  Removes the per-step
    #: host->device batch upload — the measured training bottleneck on a
    #: constrained host link (BASELINE.md) — at the cost of one upfront
    #: upload.  LJSpeech (~4 GB PCM16 padded) fits a v5e's 16 GB HBM.
    device_corpus_cache: str = "auto"
    #: HBM budget for the resident corpus (MiB); "auto" falls back to host
    #: feeding beyond this.
    device_corpus_budget_mb: int = 6144
    #: Resident-corpus storage: "pcm16" (waveforms; the step featurizes on
    #: device every step — BASELINE config 5's definition), "features"
    #: (linear+mel f32 precomputed once at corpus build; skips the
    #: featurization from the step's critical path — measured 4.1 ms of
    #: the 12.2 ms in-program step — at ~8x the HBM per utterance), or
    #: "features_bf16" (same, stored half-width: ~4x PCM16's HBM; the step
    #: casts targets back to f32, leaving ~0.4%-relative quantization on
    #: the loss targets — well under the trained model's own ~0.014 mel-L1
    #: floor — and the halved corpus is what lets steps_per_call>1 pair
    #: with a feature-resident near-budget corpus, see steps_per_call).
    device_corpus_format: str = "pcm16"
    #: Train steps executed inside ONE jitted dispatch (`lax.scan` over
    #: on-device batch gathers; requires the HBM-resident corpus).  S steps
    #: per call amortize the per-dispatch overhead floor S-fold — the lever
    #: when dispatch is the binding cost (degraded relay windows pin the
    #: single-step training loop at the ~44 ms/call floor).  Per-bucket epoch
    #: remainders (and the tail up to max_steps) run through the
    #: single-step program, so any step count is reachable.  HBM note: the
    #: grouped program's temps exceed the single-step program's by ~1 GiB
    #: at flagship shapes, so S>1 pairs with the "pcm16" corpus format — a
    #: near-budget f32 "features" corpus (~5 GiB) plus the grouped program
    #: exceeds a v5e's 16 GiB (measured: program 11.8G + args 4.9G OOM);
    #: "features_bf16" halves the corpus (~2.5 GiB) to make the pairing fit.
    steps_per_call: int = 1
    #: Tensor-parallel size of the mesh's "model" axis (1 = pure data
    #: parallelism, the primary strategy at this model scale).  >1 shards
    #: the embedding column-parallel and the post-net projection
    #: row-parallel (sstts.parallel.mesh.TP_RULES); the device count must
    #: be divisible by it.  Checkpoint-compatible either way (sharding is
    #: a layout, not a parameter-tree change).
    model_parallel: int = 1
    #: Debug mode (SURVEY.md §5.2): enable `jax_debug_nans` so the first NaN
    #: produced inside any jitted step raises with a traceback instead of
    #: silently propagating.  Disables async dispatch — training only.
    debug_nans: bool = False
    seed: int = 1234


@dataclass(frozen=True)
class EvaluationConfig:
    """Evaluation hyperparameters (reference: `tacotron/params/evaluation.py`)."""

    batch_size: int = 32
    eval_every: int = 5000
    num_eval_batches: int = 4


@dataclass(frozen=True)
class InferenceConfig:
    """Inference hyperparameters (reference: `tacotron/params/inference.py`)."""

    #: Maximum decoder steps (each emits `reduction_factor` frames).
    max_decoder_steps: int = 200
    #: Griffin-Lim iteration count.
    griffin_lim_iters: int = 60
    #: Magnitude power applied before Griffin-Lim.
    griffin_lim_power: float = 1.35
    #: Fast-Griffin-Lim momentum (0 = classic reference algorithm; ~0.99
    #: reaches 60-iteration quality in roughly half the iterations).
    griffin_lim_momentum: float = 0.0
    #: Griffin-Lim FFT implementation override (None = library default,
    #: `sstts.dsp.griffin_lim.GL_FFT_IMPL`): "dft_default" (bf16 GEMMs),
    #: "dft_high"/"dft_highest" (f32), or "xla" (jnp.fft).
    griffin_lim_fft_impl: Optional[str] = None
    #: Griffin-Lim iteration fusion override (None = library default,
    #: `sstts.dsp.griffin_lim.GL_ITER_IMPL` = "auto": the semi-fused
    #: iteration on TPU — measured fastest at headline shapes,
    #: docs/performance.md §9 — and split elsewhere): "auto" | "split"
    #: (Pallas reprojection + XLA GEMMs) | "split_xla" (no Pallas) |
    #: "semi" (reprojection + synthesis GEMM + renorm in one Pallas
    #: kernel) | "fused" (whole iteration in one Pallas kernel).
    griffin_lim_iter_impl: Optional[str] = None
    #: Autoregressive decoder implementation (None = library default,
    #: `sstts.ops.pallas_decoder.DECODER_IMPL` = "auto": the fused Pallas
    #: whole-scan kernel on TPU for Bahdanau attention — measured 2.0x the
    #: XLA scan's in-program cost — and the XLA scan elsewhere / under
    #: GSPMD meshes): "auto" | "xla" | "fused".
    decoder_impl: Optional[str] = None
    #: Stop-token probability threshold.
    stop_threshold: float = 0.5
    #: Minimum decoder steps before the stop token can fire.
    min_decoder_steps: int = 8
    #: Split Griffin-Lim vocoding into this many sub-batch programs so the
    #: host fetch of finished chunks overlaps the device compute of later
    #: ones (and the host link carries several PCM16 streams concurrently).
    #: 1 = single fused program (bitwise-stable default); 8 measured fastest
    #: on the v5e relay (BASELINE.md).  Only affects synthesis throughput,
    #: never the math: chunked and fused paths share one vocoder function.
    pipeline_chunks: int = 1
    #: Concurrent host-fetch threads when pipeline_chunks > 1.
    fetch_threads: int = 4
    #: Device->host wire codec for synthesized audio: "pcm16" (int16,
    #: lossless w.r.t. the written WAV), "mulaw8" (uint8 mu-law
    #: companding, half the bytes — for link-bound serving; ~38 dB SNR,
    #: above the Griffin-Lim quality floor), or "adpcm4" (4-bit
    #: block-adaptive linear DPCM, ~0.52 B/sample — quarter of PCM16;
    #: ~37 dB SNR on corpus speech and mel-L1-invisible under the
    #: Griffin-Lim floor, `scripts/wire_codec_gate.py`), "adpcm3"
    #: (the same DPCM at 3 bits, ~0.39 B/sample — for when the wire binds
    #: even at adpcm4; quality-gate before serving with it), or "adpcm2"
    #: (2 bits on a mid-rise lattice, ~0.27 B/sample — functional and
    #: tested but NOT serving-admitted: it FAILED the copy-synthesis
    #: mel-L1 gate at 1.29x of the lossless wire, the first codec whose
    #: noise is visible above the Griffin-Lim floor — BASELINE.md
    #: round-5 gate record; excluded from bench.py's auto-tune queue).
    #: Never affects `full_output` float32 audio.
    wire_format: str = "pcm16"
    #: Serve/evaluate from the checkpoint's EMA (Polyak-averaged)
    #: parameters instead of the raw ones (requires a checkpoint trained
    #: with `training.ema_decay` > 0; restore raises if no EMA tree is
    #: stored).  Fingerprint-neutral: EMA params share the raw tree's
    #: structure.
    use_ema: bool = False
    output_dir: str = "synthesized"


@dataclass(frozen=True)
class Config:
    """Top-level bundle, mirroring the reference's five-way hparams split."""

    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    arch: ArchitectureConfig = field(default_factory=ArchitectureConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)

    #: Fields excluded from the checkpoint fingerprint: knobs that change
    #: neither the parameter-tree structure nor the feature-space semantics
    #: of the trained state, so flipping them against an existing workdir
    #: must NOT invalidate its checkpoints.  (Storage locations, corpus
    #: selection/caps, loss weighting, and the fused-conv-bank execution
    #: strategy — whose docstring guarantees checkpoint compatibility.)
    _FINGERPRINT_EXCLUDE = {
        "dataset": frozenset(
            {
                "dataset",
                "dataset_dir",
                "cache_dir",
                "synthetic_size",
                "eval_fraction",
                "trim_top_db",
                "max_text_len",
                "max_frames",
                "resample_on_load",
                "expand_numbers",
            }
        ),
        "arch": frozenset(
            {
                "fused_conv_bank",
                "remat_decoder",
                "decoder_scan_unroll",
                "loss_low_freq_weight",
                "loss_low_freq_hz",
                "stop_token_weight",
                "guided_attention_weight",
                "guided_attention_sigma",
            }
        ),
    }

    def fingerprint(self) -> str:
        """Stable JSON fingerprint stored in checkpoints for resume validation.

        Covers only the fields that define the trained state: the dataset
        section's feature-space hyperparameters and the architecture section's
        structural hyperparameters.  Everything in `_FINGERPRINT_EXCLUDE`
        (plus the whole training/evaluation/inference sections) may be freely
        overridden when restoring a checkpoint.
        """
        sections = {"dataset": self.dataset, "arch": self.arch}
        return json.dumps(
            {
                name: {
                    k: v
                    for k, v in sorted(dataclasses.asdict(section).items())
                    if k not in self._FINGERPRINT_EXCLUDE[name]
                    # Omitted when empty so checkpoints written before the
                    # field existed keep matching; a non-empty charset
                    # extension changes the embedding table and must
                    # invalidate.
                    and not (k == "extra_chars" and not v)
                }
                for name, section in sections.items()
            },
            sort_keys=True,
        )


def with_fast_vocoder(cfg: Config) -> Config:
    """The quality-gated fast Griffin-Lim serving preset.

    30 iterations at momentum 0.99 — gated against classic GL-60 on three
    harnesses (harmonic spectral convergence 0.824x, copy-synthesis mel-L1
    0.998x, trained-checkpoint AR synthesis 0.998x; `scripts/
    gl_momentum_gate.py`, `scripts/gl_trained_ab.py`, docs/performance.md
    §9) and ~1.8x faster at serving shapes.  Inference-only fields: the
    checkpoint fingerprint is unaffected, so the preset applies to any
    existing checkpoint.  Exposed as `sstts.cli synthesize --fast-vocoder`.
    """
    return cfg.replace(
        inference=dataclasses.replace(
            cfg.inference, griffin_lim_iters=30, griffin_lim_momentum=0.99
        )
    )


def tiny_config() -> Config:
    """A miniature config for tests and compile-check entry points."""
    return Config(
        # 8 kHz keeps the 50 ms window (400 samples) inside n_fft=512 — the
        # LJSpeech-default 22.05 kHz would give win_len=1102 > n_fft, which
        # DatasetConfig now rejects (and used to fail deep in the STFT
        # window construction when a tiny config touched any DSP path).
        dataset=DatasetConfig(
            n_fft=512, n_mels=20, max_text_len=32, max_frames=64,
            sample_rate=8000, mel_fmax=4000.0,
        ),
        arch=ArchitectureConfig(
            embedding_dim=32,
            prenet_units=(32, 16),
            encoder_bank_k=4,
            encoder_bank_channels=16,
            encoder_proj_channels=(16, 16),
            encoder_highway_layers=2,
            encoder_highway_units=16,
            encoder_gru_units=16,
            attention_units=32,
            attention_gru_units=32,
            decoder_gru_layers=2,
            decoder_gru_units=32,
            reduction_factor=2,
            post_bank_k=4,
            post_bank_channels=16,
            post_proj_channels=(32, 20),
            post_highway_layers=2,
            post_highway_units=16,
            post_gru_units=16,
        ),
        training=TrainingConfig(batch_size=2, text_buckets=(16,), frame_buckets=(16,)),
        inference=InferenceConfig(max_decoder_steps=8, griffin_lim_iters=4),
    )
