"""Closed-loop synthesis through `Synthesizer.synthesize_stream`.

The traffic file gives the batch, the stream's depth, the distribution of
the texts' target durations, the speaking rate that turns a duration into
a text length, and any inference settings the mix serves with (a preset
such as the fast vocoder, a wire).

- Durations: a fixed pool of `pool` stratified quantiles of a Beta(a, b)
  scaled to [lo_s, hi_s], the same for every seed; the seed shuffles the
  pool every pass and picks the words, so every seed asks for the same
  sizes in another order.
- A text of duration d has round(d chars_per_s) characters: words from
  `portbench/words.txt`, cut to length, and a full stop.
- Texts are batched in arrival order, unsorted.  The stream decodes every
  batch for the mix's longest duration (`synthesize_stream` takes one
  `max_steps`): the stop threshold of the configuration lies above 1, so
  every row runs to the end and the padding is real work.
- The window pulls batches until `seconds` have passed, then drains the
  stream; each batch is timed from its pull to its waveforms' arrival on
  the host, and the audio counted is each text's own target duration.
  A traced run then serves `trace_batches` batches more under the
  profiler.
"""

from __future__ import annotations

import gc
import math
import time
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from portbench import harness, weights
from portbench.drivers import Result, Run

WORDS = Path(__file__).resolve().parent.parent / "words.txt"


def sub_seed(seed: int, k: int) -> int:
    return int(np.random.SeedSequence([int(seed), k]).generate_state(1, np.uint64)[0] >> 1)


def duration_pool(d: dict, n: int) -> np.ndarray:
    """`n` stratified quantiles of Beta(a, b) on [lo_s, hi_s], seconds."""
    x = np.linspace(0.0, 1.0, 200001)[1:-1]
    pdf = x ** (d["a"] - 1.0) * (1.0 - x) ** (d["b"] - 1.0)
    cdf = np.cumsum(pdf)
    cdf /= cdf[-1]
    u = (np.arange(n) + 0.5) / n
    return d["lo_s"] + (d["hi_s"] - d["lo_s"]) * np.interp(u, cdf, x)


def make_text(rng: np.random.Generator, words: List[str], n_chars: int) -> str:
    """About `n_chars` characters of whole words and a full stop (a cut
    word could read as an abbreviation that the text frontend expands)."""
    by_len: dict = {}
    for w in words:
        by_len.setdefault(len(w), []).append(w)
    out: List[str] = []
    size = -1  # the length of " ".join(out)
    while True:
        room = n_chars - 2 - size  # characters left for " word"
        if room < 1:
            break
        w = words[int(rng.integers(len(words)))]
        if len(w) > room:
            fit = by_len.get(room)
            if fit:
                out.append(fit[int(rng.integers(len(fit)))])
            break
        out.append(w)
        size += len(w) + 1
    return " ".join(out or [words[0]]) + "."


def batches(traffic: dict, seed: int) -> Iterator[Tuple[List[str], np.ndarray]]:
    """(texts, target durations) of each batch, without end."""
    words = WORDS.read_text().split()
    pool = duration_pool(traffic["duration"], traffic["pool"])
    rng = np.random.default_rng(sub_seed(seed, 1))
    B = traffic["batch"]
    while True:
        order = pool[rng.permutation(len(pool))]
        for i in range(0, len(order) - B + 1, B):
            durs = order[i : i + B]
            texts = [make_text(rng, words, int(round(d * traffic["chars_per_s"])))
                     for d in durs]
            yield texts, durs


def decode_steps(cfg_tree: dict, traffic: dict) -> int:
    """Decoder steps of the mix's longest duration."""
    ds, r = cfg_tree["dataset"], cfg_tree["arch"]["reduction_factor"]
    hop = int(ds["sample_rate"] * ds["win_hop_ms"] / 1000.0)
    return math.ceil(math.ceil(traffic["duration"]["hi_s"] * ds["sample_rate"] / hop) / r)


def text_bucket(texts: List[str], max_len: int) -> int:
    """The program's padded text width for a batch of normalised texts."""
    longest = max(len(t) for t in texts) + 1
    return min(-(-longest // 32) * 32, max_len)


def run(r: Run) -> Result:
    import torch

    from sstts_torch.synthesize import Synthesizer

    marks = [("start", time.perf_counter())]
    cfg_tree = harness.with_overrides(r.cfg_tree, {"inference": r.traffic.get("inference", {})})
    cfg = harness.config_from_dict(cfg_tree)
    dev = torch.device(r.device)
    sd = weights.make_state_dict(weights.layout(cfg), sub_seed(r.seed, 0), dev)
    marks.append(("weights", time.perf_counter()))
    synth_seed = sub_seed(r.seed, 2)
    synth = Synthesizer(cfg, sd, seed=synth_seed, device=dev)
    marks.append(("synthesizer", time.perf_counter()))
    steps = decode_steps(cfg_tree, r.traffic)
    depth = r.traffic["depth"]
    max_len = cfg.dataset.max_text_len

    gen = batches(r.traffic, r.seed)
    ahead = [next(gen) for _ in range(r.traffic["lookahead"])]
    marks.append(("texts", time.perf_counter()))
    # Warm-up: a batch of each text width the traffic will use (seen over
    # its first `lookahead` batches), then enough to fill the stream.
    seen, warm = set(), []
    for texts, durs in ahead:
        t = text_bucket(texts, max_len)
        if t not in seen:
            seen.add(t)
            warm.append((texts, durs))
    warm += ahead[: max(0, depth + 1 - len(warm))]
    for _ in synth.synthesize_stream((t for t, _ in warm), max_steps=steps, depth=depth):
        pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    served = len(warm)  # dropout seeds drawn so far
    marks.append(("warm-up", time.perf_counter()))

    def stream_source():
        yield from ahead
        yield from gen

    source = stream_source()
    rng_check = np.random.default_rng(sub_seed(r.seed, 3))
    n_check = r.traffic["check_rows"]
    sample: List[tuple] = []  # (key, batch index, row, text, duration, waveform)
    longest = None
    pulled: List[Tuple[float, List[str], np.ndarray]] = []
    done_at: List[float] = []

    def feed(seconds, n_batches):
        t0 = time.perf_counter()
        n0 = len(pulled)
        while True:
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                return
            if n_batches is not None and len(pulled) - n0 >= n_batches:
                return
            texts, durs = next(source)
            pulled.append((time.perf_counter(), texts, durs))
            yield texts

    def serve(seconds=None, n_batches=None) -> float:
        """One stream over the feed, drained; its wall seconds."""
        nonlocal longest
        t_start = time.perf_counter()
        for wavs in synth.synthesize_stream(feed(seconds, n_batches), max_steps=steps,
                                            depth=depth):
            k = len(done_at)
            done_at.append(time.perf_counter())
            _, texts, durs = pulled[k]
            row = int(rng_check.integers(len(wavs)))
            key = float(rng_check.random())
            item = (key, served + k, row, texts[row], float(durs[row]), wavs[row].copy())
            if len(sample) < n_check:
                sample.append(item)
            else:
                worst = max(range(n_check), key=lambda i: sample[i][0])
                if key < sample[worst][0]:
                    sample[worst] = item
            j = int(np.argmax(durs))
            if longest is None or durs[j] > longest[4]:
                longest = (-1.0, served + k, j, texts[j], float(durs[j]), wavs[j].copy())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t_start

    r.on_timed()
    window = serve(seconds=r.seconds)
    n_window = len(done_at)
    trace = None
    if r.trace:
        # The same stream under the profiler, for `trace_batches` batches
        # more; the untraced window gives the wall time a batch, which the
        # profiler's own cost on the host would stretch.
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            traced_s = serve(n_batches=r.traffic["trace_batches"])
        events, host = harness.profile_events(prof)
        del prof
        r_fac = cfg.arch.reduction_factor
        units = [{"B": len(texts), "T": text_bucket(texts, max_len), "S": steps,
                  "F": steps * r_fac, "audio_s": float(np.sum(durs))}
                 for _, texts, durs in pulled[n_window:]]
        trace = harness.Trace(cfg_tree, units, traced_s, events, host,
                              unit_s=window / max(n_window, 1))
    n_done = len(done_at)
    lat = [done_at[k] - pulled[k][0] for k in range(n_window)]
    audio = float(sum(np.sum(pulled[k][2]) for k in range(n_window)))
    e2e = {"audio_rtf": audio / window, "batch_p95_s": float(np.percentile(lat, 95))}
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    attempted = sum(len(p[1]) for p in pulled)
    completed = sum(len(pulled[k][1]) for k in range(n_done))
    if longest is not None and all(s[1:3] != longest[1:3] for s in sample):
        sample.append(longest)
    del synth
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from portbench import check

    per_row: list = []
    checks = check.synthesis_checks(sd, cfg_tree, sample, steps, synth_seed, r.limits, dev,
                                    per_row)
    res = Result(e2e=e2e, attempted=attempted, failed=attempted - completed, checks=checks,
                 trace=trace, memory_peak_bytes=peak)
    res.notes.append("set-up in the driver: " + ", ".join(
        f"{n} {b - a:.3f} s" for (_, a), (n, b) in zip(marks, marks[1:])))
    res.notes.append("rows compared (batch, row, target s: gaps): " + "; ".join(
        f"{b} {rw} {d:.2f}: " + " ".join(f"{k} {v:.4g}" for k, v in g.items())
        for (_, b, rw, _, d, _), g in zip(sample, per_row)))
    res.notes.append(f"batches {n_window} in {window:.3f} s, {steps} decoder steps, "
                     f"text widths warmed {sorted(seen)}")
    return res


def control(cfg_tree: dict, traffic: dict, seed: int, device, rows=None):
    """(control name, readings) for the rows a window of `seed` would
    sample: each control precision's reference audio against the stated
    reference's, by the run's own comparison."""
    import torch

    from portbench import check
    from portbench.reference import CONTROLS, STATED

    cfg_tree = harness.with_overrides(cfg_tree, {"inference": traffic.get("inference", {})})
    cfg = harness.config_from_dict(cfg_tree)
    dev = torch.device(device)
    sd = weights.make_state_dict(weights.layout(cfg), sub_seed(seed, 0), dev)
    synth_seed = sub_seed(seed, 2)
    steps = decode_steps(cfg_tree, traffic)
    rng = np.random.default_rng(sub_seed(seed, 3))
    gen = batches(traffic, seed)
    sample = []
    for k in range(traffic["check_rows"]):
        texts, durs = next(gen)
        row = int(np.argmax(durs)) if k == 0 else int(rng.integers(len(texts)))
        sample.append((0.0, k, row, texts[row], float(durs[row]), None))
    ref = check.reference_rows(sd, cfg_tree, sample, steps, synth_seed, STATED, dev)
    for name, P in CONTROLS.items():
        got = check.reference_rows(sd, cfg_tree, sample, steps, synth_seed, P, dev)
        per = [] if rows is not None else None
        gaps = check.row_gaps(got, ref, cfg_tree["dataset"], per)
        if rows is not None:
            rows.append((name, per))
        yield name, gaps
