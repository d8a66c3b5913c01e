"""Corpus records and the train/eval split: the port of
`sstts/data/ljspeech.py` (21-30, 58-64).

The split hashes utterance ids, so it is stable across runs and machines.
Reading an LJSpeech `metadata.csv` (`load_metadata`) is not ported yet: no
corpus is in the repository (ROADMAP A.6).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class Utterance:
    uid: str
    wav_path: str
    text: str  # normalized


def _stable_fraction(uid: str) -> float:
    digest = hashlib.sha1(uid.encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


def train_eval_split(
    utts: List[Utterance], eval_fraction: float
) -> Tuple[List[Utterance], List[Utterance]]:
    train, evals = [], []
    for u in utts:
        (evals if _stable_fraction(u.uid) < eval_fraction else train).append(u)
    return train, evals
