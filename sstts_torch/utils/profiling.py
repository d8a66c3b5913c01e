"""Tracing and timing: the port of `sstts/utils/profiling.py`.

`trace(logdir)` records a `torch.profiler` trace of the block (host ops,
and the card's kernels where CUDA is available) and writes it to
`logdir/trace.json`, a Chrome trace that Perfetto or chrome://tracing
opens.  `timed` gives the median and 10th/90th percentile wall times of a
call, each timing ending when the card has finished the call's work
(`torch.cuda.synchronize`), as the reference's ends with a host transfer.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile the block; the trace lands in `logdir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(logdir / "trace.json"))


def _wait() -> None:
    """Wait for the card where this process has used it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, trials: int = 5, warmup: int = 1) -> Dict[str, float]:
    """Median/percentile wall times of `fn(*args)`, each waiting for the
    card to finish."""
    for _ in range(warmup):
        fn(*args)
        _wait()
    times: List[float] = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn(*args)
        _wait()
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "median_s": float(np.median(arr)),
        "p10_s": float(np.percentile(arr, 10)),
        "p90_s": float(np.percentile(arr, 90)),
        "trials": float(trials),
    }
