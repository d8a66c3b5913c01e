"""Tracing and timing: the port of `sstts/utils/profiling.py`, and the
program's spans.

`trace(logdir)` records a `torch.profiler` trace of the block (host ops
of every thread, and the card's kernels where CUDA is available) and
writes it to `logdir/trace.json`, a Chrome trace that Perfetto or
chrome://tracing opens.

`span(name)` marks one phase of the program on the profiler's clock, a
`record_function` while a profiler runs and a shared no-op otherwise (a
`record_function` costs microseconds even with no profiler, and the
Griffin-Lim loop opens one an iteration).  A span ends when the host has
enqueued the phase's work, not when the card has run it: it never waits
for the card and reads no tensor.  Its name is one of `SPANS`, a fixed
set with no index or shape in it, so that a trace groups by name; the
n-th spans of one name belong to the n-th batch or step.  A profiler
records the spans of the thread that started it (and autograd's);
`trace` records every thread's, the fetch threads' included.

`timed` gives the median and 10th/90th percentile wall times of a
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
import torch.autograd.profiler as _autograd_profiler

#: Every span the program opens, each with what it covers.
SPANS = (
    "sstts.synth.dispatch",  # the enqueue of one batch, its pinned copies and event
    "sstts.synth.text",  # the text frontend
    "sstts.synth.encode",  # the encoder
    "sstts.synth.decode",  # the fused decode (its preparation and B4) or the plain loop
    "sstts.synth.postprocess",  # the post-CBHG and the frame mask
    "sstts.synth.wire",  # the wire's encode on the device
    "sstts.synth.wait",  # the stream waiting on its oldest batch's fetch
    "sstts.synth.fetch",  # a fetch thread: the event wait, the wire's decode, the trim
    "sstts.gl.setup",  # Griffin-Lim's DFT matrices, band plan and K-major copies
    "sstts.gl.iter",  # one Griffin-Lim iteration
    "sstts.gl.edges",  # the edge rows' repair after B2 or B5
    "sstts.train.step",  # one train step
    "sstts.train.gather",  # the cached step's index upload and gather
    "sstts.train.features",  # the step's features on the device
    "sstts.train.forward",  # the forward and the loss
    "sstts.train.backward",  # zero_grad and the backward
    "sstts.train.scan_grad",  # B6's backward, whatever its route
    "sstts.train.scan_graph",  # in it, a replay of a captured graph and its clones
    "sstts.train.update",  # the gradients' fill, norm and clip, Adam, the EMA
)
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks `name` (one of `SPANS`) in a running
    profiler's trace; with none running, a shared no-op."""
    # `_is_profiler_enabled` holds on every thread while any profiler runs
    # (`torch._C._autograd._profiler_enabled()` reads False off the thread
    # that started it when all threads are profiled).
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if name not in SPANS:
        raise ValueError(f"unknown span {name!r}; the program's spans are SPANS")
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Profile the block, every thread of it; the trace lands in
    `logdir/trace.json`."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
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
