"""Training over a device-resident PCM16 corpus: `train.build_device_corpus`
(features made on the device inside each step), then
`train.make_cached_train_step` on batches that `train.cached_epoch_indices`
draws, one epoch after another: the path `train.train` takes at
`device_corpus_cache="auto"` for a corpus that fits.

The traffic file gives the corpus: `utterances` utterances of durations
from a fixed pool of evenly spaced values on [lo_s, hi_s] (the same for
every seed) and `chars_per_s` characters a second, which the seed
shuffles and fills with words; each utterance's audio is one tone pair a
character, its pitch from the character, with 1% noise.  The traffic is
sized so that every utterance falls in one bucket, so the seed changes
the contents and not the shapes.

Set-up builds the train state from the seed's weights and drives its first
`check_steps` steps through the window's own call on distinct rows; the
reference follows them from the same weights and rows (`check`), after the
window.  The window then runs steps until `seconds` have passed and waits
for the card; a traced run then runs `trace_steps` steps more under the
profiler.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from portbench import harness, weights
from portbench.drivers import Result, Run
from portbench.drivers.synth_stream import WORDS, make_text, sub_seed


class AudioCache(dict):
    """Audio by utterance id, as the program's `Batcher` reads a cache."""

    def get(self, uid):  # noqa: D102 - the Batcher's cache interface
        return self[uid]

    def length(self, uid):
        return len(self[uid])


def corpus(traffic: dict, sample_rate: int, seed: int):
    """[(uid, text, float32 audio)] of the traffic's corpus for `seed`."""
    rng = np.random.default_rng(sub_seed(seed, 1))
    words = WORDS.read_text().split()
    n = traffic["utterances"]
    lo, hi = traffic["duration_s"]
    durs = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    durs = durs[rng.permutation(n)]
    out = []
    for i, d in enumerate(durs):
        t = make_text(rng, words, int(round(d * traffic["chars_per_s"])))
        n_samp = int(d * sample_rate)
        per = np.full(len(t), n_samp // len(t))
        per[: n_samp - per.sum()] += 1
        f0 = np.repeat(110.0 + 12.0 * (np.frombuffer(t.encode(), np.uint8) % 32), per)
        phase = np.cumsum(2.0 * np.pi * f0 / sample_rate)
        y = 0.4 * np.sin(phase) + 0.15 * np.sin(2.0 * phase)
        y += 0.01 * rng.standard_normal(n_samp)
        out.append((f"PB-{i:05d}", t, y.astype(np.float32)))
    return out


def stated(dev):
    """The configuration's precision as the program states it on `dev`:
    the teacher-forced scan's products in bfloat16 on the card, float32
    on the CPU (the program's teacher dtype)."""
    import torch

    from portbench.reference import STATED, Precision

    return STATED if dev.type == "cuda" else Precision(torch.float32, torch.float32)


def the_bucket(cfg, utts) -> int:
    """The one bucket the corpus's utterances fall in."""
    from sstts_torch.data.pipeline import assign_bucket, frame_bucket_shapes

    hop = cfg.dataset.hop_len
    shapes = frame_bucket_shapes(cfg)
    found = {assign_bucket(len(t) + 1, 1 + len(y) // hop, shapes) for _, t, y in utts}
    if len(found) != 1 or -1 in found:
        raise RuntimeError(f"the corpus spans buckets {sorted(found)}; the traffic keeps one")
    return found.pop()


def epochs(counts: Dict[int, int], batch: int, seed: int):
    """(bucket, idx, valid) for ever, one shuffled epoch after another."""
    from sstts_torch.train import cached_epoch_indices

    e = 0
    while True:
        yield from cached_epoch_indices(counts, batch, sub_seed(seed, 100 + e))
        e += 1


def run(r: Run) -> Result:
    import torch

    from sstts_torch import train as train_mod
    from sstts_torch.data.ljspeech import Utterance
    from sstts_torch.data.pipeline import Batcher, frame_bucket_shapes
    from sstts_torch.model.tacotron import Tacotron

    cfg_tree = r.cfg_tree
    cfg = harness.config_from_dict(cfg_tree)
    dev = torch.device(r.device)
    sd = weights.make_state_dict(weights.layout(cfg), sub_seed(r.seed, 0), dev)
    model = Tacotron(cfg.arch, cfg.dataset).to(dev)
    model.load_state_dict(sd)
    state = train_mod.TrainState(0, model, train_mod.make_optimizer(cfg, model.parameters()))
    utts = corpus(r.traffic, cfg.dataset.sample_rate, r.seed)
    cache = AudioCache({u: y for u, _, y in utts})
    batcher = Batcher([Utterance(u, "", t) for u, t, _ in utts], cfg, audio_cache=cache)
    built, why = train_mod.build_device_corpus(cfg, None, batcher=batcher, device=dev)
    if built is None:
        raise RuntimeError(f"the corpus does not fit the device: {why}")
    dcorpus, counts = built
    if len(counts) != 1 or sum(counts.values()) != len(utts):
        raise RuntimeError(f"the corpus spans buckets {counts}; the traffic keeps one")
    step = train_mod.make_cached_train_step(cfg)
    order = epochs(counts, r.traffic["batch"], r.seed)
    bucket = next(iter(counts))
    shape = frame_bucket_shapes(cfg)[bucket]

    # The first steps, read for the check before the next step moves them.
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    checked: List[tuple] = []
    losses: List[float] = []
    grad1: Dict[str, float] = {}
    beta1 = cfg.training.adam_beta1
    for k in range(r.traffic["check_steps"]):
        b, idx, valid = next(order)
        checked.append((idx.copy(), valid.copy()))
        m = step(state, dcorpus[b], idx, valid)
        losses.append(float(m["loss"]))
        if k == 0:
            for n, p in model.named_parameters():
                m1 = state.optimizer.state[p].get("exp_avg")  # none: it took no step
                grad1[n] = 0.0 if m1 is None else float(torch.linalg.vector_norm(m1)) / (1 - beta1)
    delta = {n: float(torch.linalg.vector_norm(p.detach() - p0[n]))
             for n, p in model.named_parameters()}
    del p0
    b, idx, valid = next(order)  # one more warm step on the window's path
    step(state, dcorpus[b], idx, valid)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    def steps_for(seconds=None, n=None):
        """(steps, utterances, wall seconds) of steps run until `seconds`
        have passed or `n` steps are done, the card waited for."""
        t0 = time.perf_counter()
        n_steps, n_utts = 0, 0
        while (n_steps < n) if n is not None else (time.perf_counter() - t0 < seconds):
            b, idx, valid = next(order)
            step(state, dcorpus[b], idx, valid)
            n_steps += 1
            n_utts += int(np.sum(valid > 0))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return n_steps, n_utts, time.perf_counter() - t0

    r.on_timed()
    n_steps, n_utts, window = steps_for(seconds=r.seconds)
    trace = None
    if r.trace:
        # Steps more under the profiler; the untraced window gives the
        # wall time a step, which the profiler's own cost would stretch.
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            n_traced, _, traced_s = steps_for(n=r.traffic["trace_steps"])
        events, host = harness.profile_events(prof)
        del prof
        units = [{"B": r.traffic["batch"], "T": shape[0], "F": shape[1]}] * n_traced
        trace = harness.Trace(cfg_tree, units, traced_s, events, host,
                              unit_s=window / max(n_steps, 1))
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    del state, model, dcorpus, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from portbench import check

    got = {"loss": losses, "grad1": grad1, "delta": delta}
    rows = [(t, y) for _, t, y in utts]  # the device corpus's row order
    info: dict = {}
    checks = check.train_checks(sd, cfg_tree, rows, checked, shape, got, r.limits, dev,
                                stated(dev), info)
    res = Result(e2e={"train_utt_per_s": n_utts / window}, attempted=n_steps, failed=0,
                 checks=checks, trace=trace, memory_peak_bytes=peak)
    res.notes.append(f"steps {n_steps} in {window:.3f} s; bucket {bucket} {shape}, "
                     f"{counts[bucket]} utterances; update_gap over {info['leaves']} leaves, "
                     f"left out {info['left_out']}")
    return res



def control(cfg_tree: dict, traffic: dict, seed: int, device, rows=None):
    """(control name, readings): each control precision's reference steps
    against the stated reference's, on the rows a run of `seed` checks,
    then the half-batch fault's.  (A state left unchanged reads 1 in
    `grad_gap` and `update_gap` by their definition.)"""
    import torch

    from portbench import check
    from portbench.reference import CONTROLS
    from portbench.reference import train as ref_train
    from sstts_torch.data.pipeline import frame_bucket_shapes

    cfg = harness.config_from_dict(cfg_tree)
    dev = torch.device(device)
    sd = weights.make_state_dict(weights.layout(cfg), sub_seed(seed, 0), dev)
    utts = corpus(traffic, cfg.dataset.sample_rate, seed)
    rows = [(t, y) for _, t, y in utts]
    bucket = the_bucket(cfg, utts)
    shape = frame_bucket_shapes(cfg)[bucket]
    order = epochs({bucket: len(rows)}, traffic["batch"], seed)
    checked = [next(order)[1:] for _ in range(traffic["check_steps"])]
    batches = check.train_batches(rows, checked, shape, cfg_tree["dataset"])
    ref = ref_train.train_steps(sd, cfg_tree, batches, stated(dev), dev)
    for name, P in CONTROLS.items():
        got = ref_train.train_steps(sd, cfg_tree, batches, P, dev)
        yield name, check.train_gaps(got, ref)
    # A fault planted in the reference in the program's place: half of each
    # batch left out, the mean taken over the rest.
    half = []
    for (ids, samples, frames, lf), valid in batches:
        lf = lf.copy()
        lf[: len(lf) // 2] = 0
        half.append(((ids, samples, frames, lf), valid))
    got = ref_train.train_steps(sd, cfg_tree, half, stated(dev), dev)
    yield "fault_half_batch", check.train_gaps(got, ref)
