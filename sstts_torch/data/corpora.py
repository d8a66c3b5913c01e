"""The Blizzard-2011 "Nancy" and CSS10 corpora: the port of
`sstts/data/corpora.py`, on the corpora's public distribution layouts.

* **Blizzard 2011 "Nancy"**: a festival-style ``prompts.data`` file of
  ``( <uid> "<text>" )`` records, waveforms in ``wavn/<uid>.wav``
  (``wavs/`` where there is no ``wavn/``).
* **CSS10**: ``transcript.txt`` of ``<wav path>|<raw text>|<normalized
  text>|<duration>`` rows relative to the corpus root.

Both normalize through the text front-end (`sstts_torch.data.text`); with
the default charset non-ASCII letters transliterate, and
``dataset.extra_chars`` keeps them.  A corpus at another sample rate is
resampled by `sstts_torch.data.pipeline.load_audio` when
``dataset.resample_on_load`` is set, and refused otherwise.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List

from sstts_torch.config import DatasetConfig
from sstts_torch.data import text as text_mod
from sstts_torch.data.ljspeech import Utterance

_PROMPT_RE = re.compile(r"\(\s*(\S+)\s+\"(.*?)\"\s*\)", re.DOTALL)


def _keep(cfg: DatasetConfig, norm: str) -> bool:
    return bool(norm) and len(norm) + 1 <= cfg.max_text_len


def load_blizzard_nancy(cfg: DatasetConfig) -> List[Utterance]:
    """Parse a Blizzard-2011 (Nancy corpus) style prompts file."""
    root = Path(cfg.dataset_dir)
    prompts = root / "prompts.data"
    if not prompts.exists():
        raise FileNotFoundError(
            f"Blizzard prompts file not found at {prompts}; "
            "set DatasetConfig.dataset_dir to the corpus root"
        )
    wav_dir = root / "wavn"
    if not wav_dir.is_dir():
        wav_dir = root / "wavs"
    utts: List[Utterance] = []
    for match in _PROMPT_RE.finditer(prompts.read_text(encoding="utf-8")):
        uid, raw = match.group(1), match.group(2)
        norm = text_mod.normalize(raw, cfg.extra_chars, cfg.expand_numbers)
        if not _keep(cfg, norm):
            continue
        utts.append(Utterance(uid, str(wav_dir / f"{uid}.wav"), norm))
    return utts


def load_css10(cfg: DatasetConfig) -> List[Utterance]:
    """Parse a CSS10-layout corpus (e.g. the German single-speaker set)."""
    root = Path(cfg.dataset_dir)
    meta = root / "transcript.txt"
    if not meta.exists():
        raise FileNotFoundError(
            f"CSS10 transcript not found at {meta}; "
            "set DatasetConfig.dataset_dir to the corpus root"
        )
    utts: List[Utterance] = []
    for line in meta.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        parts = line.split("|")
        if len(parts) < 2:
            continue
        rel = parts[0].strip()
        raw = parts[2] if len(parts) > 2 and parts[2].strip() else parts[1]
        norm = text_mod.normalize(raw, cfg.extra_chars, cfg.expand_numbers)
        if not _keep(cfg, norm):
            continue
        # The uid keeps the directory: CSS10 numbers its files per book
        # ("book_a/1.wav", "book_b/1.wav"), so a bare stem would collide in
        # the uid-keyed cache and split.
        uid = str(Path(rel).with_suffix("")).replace("/", "_")
        utts.append(Utterance(uid, str(root / rel), norm))
    return utts
