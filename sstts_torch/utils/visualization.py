"""Spectrogram and attention-alignment plots: a copy of
`sstts/utils/visualization.py`, so the port imports nothing of the JAX
package.  Returns RGB uint8 arrays for `MetricsLogger.log_image`;
matplotlib stays a lazy optional dependency (an ImportError reaches the
caller, which skips its plots)."""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def _render(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    import matplotlib.pyplot as plt

    plt.close(fig)
    return buf


def plot_spectrogram(
    spec: np.ndarray,
    title: str = "spectrogram",
    path: Optional[str | Path] = None,
) -> np.ndarray:
    """(frames, bins) normalized spectrogram -> RGB image array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(
        np.asarray(spec).T, origin="lower", aspect="auto", interpolation="none"
    )
    ax.set_xlabel("frame")
    ax.set_ylabel("bin")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=100)
    return _render(fig)


def plot_attention_alignment(
    alignment: np.ndarray,
    title: str = "attention alignment",
    path: Optional[str | Path] = None,
) -> np.ndarray:
    """(decoder_steps, encoder_steps) alignment -> RGB image array."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(
        np.asarray(alignment).T, origin="lower", aspect="auto",
        interpolation="none",
    )
    ax.set_xlabel("decoder step")
    ax.set_ylabel("encoder step")
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    if path is not None:
        fig.savefig(path, dpi=100)
    return _render(fig)
