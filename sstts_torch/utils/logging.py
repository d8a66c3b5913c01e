"""Metrics logging: the port of `sstts/utils/logging.py`.

One record per call to `log`, appended to `workdir/metrics.jsonl` in the
JAX package's shape, ``{"step", "wall_s", "prefix", <metric>: value}``, and
one console line ``[prefix] step N: k=v, ...``; so one tool reads the run
directory of either package.  TensorBoard events go to `workdir/tb`
through `torch.utils.tensorboard` where that imports (it needs the
`tensorboard` package), and nowhere otherwise, as the JAX logger does
with TensorFlow.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np


def _tensorboard_writer(logdir: Path):
    """A `SummaryWriter` on `logdir`, or None where it does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return None
    return SummaryWriter(str(logdir))


class MetricsLogger:
    def __init__(self, workdir: str | Path, use_tensorboard: bool = True):
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.workdir / "metrics.jsonl", "a", buffering=1)
        self._tb = _tensorboard_writer(self.workdir / "tb") if use_tensorboard else None
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "train") -> None:
        record = {
            "step": int(step),
            "wall_s": round(time.time() - self._t0, 3),
            "prefix": prefix,
        }
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._jsonl.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(f"{prefix}/{k}", float(v), int(step))
                except (TypeError, ValueError):
                    pass
        scalars = ", ".join(
            f"{k}={float(v):.4f}" for k, v in metrics.items() if hasattr(v, "__float__")
        )
        print(f"[{prefix}] step {step}: {scalars}", flush=True)

    def log_image(self, step: int, tag: str, image) -> None:
        """image: (H, W, C) uint8/float array; TensorBoard only."""
        if self._tb is None:
            return
        img = np.asarray(image)
        if img.ndim == 3:
            img = img[None]
        self._tb.add_images(tag, img, int(step), dataformats="NHWC")

    def log_audio(self, step: int, tag: str, wav, sample_rate: int) -> None:
        if self._tb is None:
            return
        w = np.asarray(wav, dtype=np.float32).reshape(-1)
        peak = np.abs(w).max() if w.size else 0.0
        if peak > 1.0:
            w = w / peak
        self._tb.add_audio(tag, w, int(step), sample_rate=sample_rate)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
