"""Shared set-up of the mesh tests (`tests/test_torch_mesh_*.py`): a tiny
configuration with a batch of 4, seeded ragged batches, a seeded corpus on
disk and a relative L2 over dicts of tensors.  The synthetic corpus's
noise follows Python's per-process string hash, so these make their audio
from numpy seeds: every process sees the same.  No JAX here."""

import dataclasses

import numpy as np

from sstts_torch.config import tiny_config
from sstts_torch.data import pipeline
from sstts_torch.data import wav as wav_mod
from sstts_torch.data.synthetic import make_utterances

#: Seconds a launch (and each collective in it) may take before it fails.
TIMEOUT = 300.0


def mesh_cfg(dropout=0.5, lr=2e-4):
    cfg = tiny_config()
    return cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, dataset="synthetic"),
        arch=dataclasses.replace(cfg.arch, prenet_dropout=dropout),
        training=dataclasses.replace(
            cfg.training, batch_size=4, text_buckets=(32,), frame_buckets=(64,),
            learning_rate=lr,
        ),
    )


def seeded_batches(cfg, steps: int, seed: int = 11):
    """`steps` global batches of 4 utterances, their audio a seeded tone in
    noise of ragged lengths (the synthetic corpus's noise follows Python's
    per-process string hash, so it would differ between processes)."""
    rng = np.random.default_rng(seed)
    sr, hop = cfg.dataset.sample_rate, cfg.dataset.hop_len
    lt, fr = pipeline.frame_bucket_shapes(cfg)[0]
    utts = make_utterances(4 * steps, cfg.dataset, min_words=1, max_words=2)
    batches = []
    for s in range(steps):
        items = []
        for u in utts[4 * s : 4 * s + 4]:
            n = int(rng.integers(12 * hop, (fr - 2) * hop))
            items.append((pipeline.text_mod.encode(u.text), _tone(rng, n, sr)))
        batches.append(pipeline.make_batch(items, lt, fr, cfg))
    return batches


def _tone(rng, n: int, sr: int) -> np.ndarray:
    t = np.arange(n) / sr
    y = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 400) * t)
    return (y + 0.05 * rng.standard_normal(n)).astype(np.float32)


def write_ljspeech(root, n: int, ds, seed: int = 3):
    """An LJSpeech-layout corpus of `n` utterances (`metadata.csv` +
    `wavs/`), each a seeded tone in noise 60 ms a character with 0.2 s of
    silence at each end, the same in every process."""
    rng = np.random.default_rng(seed)
    pad = np.zeros(int(0.2 * ds.sample_rate), np.float32)
    lines = []
    for u in make_utterances(n, ds, min_words=1, max_words=2):
        y = _tone(rng, int(0.06 * ds.sample_rate) * len(u.text), ds.sample_rate)
        (root / "wavs").mkdir(parents=True, exist_ok=True)
        wav_mod.save_wav(root / "wavs" / f"{u.uid}.wav", np.concatenate([pad, y, pad]),
                         ds.sample_rate)
        lines.append(f"{u.uid}|{u.text}|{u.text}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    return root


def rel_l2(got: dict, ref: dict, select=None) -> float:
    num = den = 0.0
    for k, r in ref.items():
        g, r = got[k].double(), r.double()
        if select is not None:
            g, r = g[select[k]], r[select[k]]
        num += float((g - r).pow(2).sum())
        den += float(r.pow(2).sum())
    return (num / den) ** 0.5
