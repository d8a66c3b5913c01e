"""The LJSpeech corpus: the port of `sstts/data/ljspeech.py`.

`load_metadata` parses `metadata.csv` (``id|raw text|normalized text``
rows, `wavs/<id>.wav` beside it) into normalized utterances.  The split
hashes utterance ids, so it is stable across runs and machines, and agrees
with the JAX package's.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

from sstts_torch.config import DatasetConfig
from sstts_torch.data import text as text_mod


@dataclass(frozen=True)
class Utterance:
    uid: str
    wav_path: str
    text: str  # normalized


def _stable_fraction(uid: str) -> float:
    digest = hashlib.sha1(uid.encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


def load_metadata(cfg: DatasetConfig) -> List[Utterance]:
    """Parse LJSpeech metadata.csv -> normalized utterances; the normalized
    column (numbers spelled out) is preferred where present, and texts
    that normalize to nothing or exceed `max_text_len` are dropped."""
    root = Path(cfg.dataset_dir)
    meta = root / "metadata.csv"
    if not meta.exists():
        raise FileNotFoundError(
            f"LJSpeech metadata not found at {meta}; set DatasetConfig.dataset_dir"
        )
    utts: List[Utterance] = []
    for line in meta.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        parts = line.split("|")
        uid = parts[0].strip()
        raw = parts[2] if len(parts) > 2 and parts[2].strip() else parts[1]
        norm = text_mod.normalize(raw, cfg.extra_chars, cfg.expand_numbers)
        if not norm or len(norm) + 1 > cfg.max_text_len:
            continue
        utts.append(Utterance(uid, str(root / "wavs" / f"{uid}.wav"), norm))
    return utts


def train_eval_split(
    utts: List[Utterance], eval_fraction: float
) -> Tuple[List[Utterance], List[Utterance]]:
    train, evals = [], []
    for u in utts:
        (evals if _stable_fraction(u.uid) < eval_fraction else train).append(u)
    return train, evals
