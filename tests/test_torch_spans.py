"""The program's spans (`sstts_torch.utils.profiling.span`) on the CPU, at
`tiny_config` widths: off without a profiler, and under one where the
benchmark's traced window reads them (`portbench.harness.profile_events`
of a plain `torch.profiler.profile`, as its drivers run it): the phases
of a streamed batch and of a cached train step nested in time, and the
fetch threads' spans in `profiling.trace()`'s file.

Torch runs on one thread here: the tiny model gains nothing from more, and
a test suite with one process per core oversubscribes.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch
import torch.autograd.profiler
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from sstts_torch import train as ptrain
from sstts_torch.config import tiny_config
from sstts_torch.data.synthetic import make_utterances
from sstts_torch.model.tacotron import init_state_dict
from sstts_torch.synthesize import Synthesizer
from sstts_torch.utils import profiling

GL_ITERS = 3
BATCHES = [["hello world", "abc"], ["a much longer sentence"]]
TRAIN_PHASES = ("sstts.train.features", "sstts.train.forward", "sstts.train.backward",
                "sstts.train.update")
BATCH_PHASES = ("sstts.synth.text", "sstts.synth.encode", "sstts.synth.decode",
                "sstts.synth.postprocess", "sstts.gl.setup", "sstts.synth.wire")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def synth():
    cfg = tiny_config()
    cfg = cfg.replace(inference=dataclasses.replace(
        cfg.inference, griffin_lim_iters=GL_ITERS, max_decoder_steps=6, min_decoder_steps=2))
    return Synthesizer(cfg, init_state_dict(cfg.arch, cfg.dataset, 0), seed=3, device="cpu")


@pytest.fixture(scope="module")
def train_step():
    """A function that runs one cached train step on a fresh tiny state."""
    cfg = tiny_config()
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, dataset="synthetic"),
        arch=dataclasses.replace(cfg.arch, prenet_dropout=0.0),
        training=dataclasses.replace(cfg.training, batch_size=2, text_buckets=(16, 48),
                                     frame_buckets=(48, 96)),
    )
    utts = make_utterances(8, cfg.dataset, min_words=1, max_words=2)
    (corpus, counts), _ = ptrain.build_device_corpus(cfg, utts, device="cpu")
    bucket = min(b for b, n in counts.items() if n >= 2)
    step = ptrain.make_cached_train_step(cfg)

    def run():
        state = ptrain.create_state(cfg, seed=0, device="cpu")
        state.model.teacher_impl = "fused"  # the card's scan, under its autograd.Function
        return step(state, corpus[bucket], np.array([0, 1], np.int32), np.ones(2, np.float32))

    return run


def _stream(synth):
    return list(synth.synthesize_stream(BATCHES, depth=1))


@pytest.fixture(scope="module")
def traced(synth, train_step):
    """The host events of a profiled stream and of a profiled train step."""
    with profile(activities=[ProfilerActivity.CPU]) as p_synth:
        wavs = _stream(synth)
    with profile(activities=[ProfilerActivity.CPU]) as p_train:
        train_step()
    assert len(wavs) == len(BATCHES)
    return {"synth": harness.profile_events(p_synth)[1],
            "train": harness.profile_events(p_train)[1]}


def _named(events, name):
    return [e for e in events if e[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_profiler_flag_is_read_on_every_thread():
    """`span` turns on from `torch.autograd.profiler._is_profiler_enabled`:
    it has to exist, and to read True on the profiling thread and on any
    other while a profiler runs, False after."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    seen = {}

    def look():
        seen["other"] = torch.autograd.profiler._is_profiler_enabled
        seen["span"] = type(profiling.span("sstts.synth.fetch"))

    with profile(activities=[ProfilerActivity.CPU]):
        seen["main"] = torch.autograd.profiler._is_profiler_enabled
        t = threading.Thread(target=look)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == {"main": True, "other": True, "span": torch.profiler.record_function}
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_no_record_function_without_a_profiler(monkeypatch, synth, train_step):
    """With no profiler, every span is one shared no-op, and a streamed
    batch and a train step enter no `record_function`."""
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    noop = profiling.span(profiling.SPANS[0])
    assert all(profiling.span(n) is noop for n in profiling.SPANS)
    with noop:
        with noop:
            pass
    _stream(synth)
    train_step()
    assert entered == []


def test_unknown_span_names_are_refused():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="unknown span"):
            profiling.span("sstts.synth.batch_3")


def test_stream_spans_nest_by_batch(traced):
    """One dispatch a batch holding each of its phases once and every
    Griffin-Lim iteration, each edge repair inside an iteration, and one
    wait a yielded batch outside every dispatch."""
    host = traced["synth"]
    dispatches = _named(host, "sstts.synth.dispatch")
    assert len(dispatches) == len(BATCHES)
    per_batch = {**{n: 1 for n in BATCH_PHASES}, "sstts.gl.iter": GL_ITERS,
                 "sstts.gl.edges": GL_ITERS}
    for name, want in per_batch.items():
        spans = _named(host, name)
        assert len(spans) == want * len(BATCHES), name
        assert [sum(_inside(s, d) for s in spans) for d in dispatches] == [want] * len(BATCHES)
    iters = _named(host, "sstts.gl.iter")
    for e in _named(host, "sstts.gl.edges"):
        assert sum(_inside(e, i) for i in iters) == 1
    for setup in _named(host, "sstts.gl.setup"):
        assert not any(_inside(i, setup) for i in iters)
    waits = _named(host, "sstts.synth.wait")
    assert len(waits) == len(BATCHES)
    assert not any(_inside(w, d) for w in waits for d in dispatches)


def test_train_step_spans(traced):
    """A cached step: the gather, then one step holding its four phases in
    order, and autograd's backward functions inside the backward span."""
    host = traced["train"]
    (step,) = _named(host, "sstts.train.step")
    (gather,) = _named(host, "sstts.train.gather")
    assert gather[2] <= step[1]
    phases = []
    for name in TRAIN_PHASES:
        (p,) = _named(host, name)
        assert _inside(p, step), name
        phases.append(p)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    backward = phases[2]
    grads = [e for e in host if e[0].startswith("autograd::engine::evaluate_function")]
    assert grads and all(_inside(g, backward) for g in grads)
    (scan,) = _named(host, "sstts.train.scan_grad")  # B6's backward, eager on the CPU
    assert _inside(scan, backward) and not _named(host, "sstts.train.scan_graph")


def test_every_span_is_named_in_spans(traced):
    """The names opened are `SPANS`, each of them but the fetch threads'
    (which a plain profiler does not record) and a captured graph's
    replay (the card's only) opened by these runs."""
    opened = {e[0] for events in traced.values() for e in events if e[0].startswith("sstts.")}
    assert opened <= set(profiling.SPANS)
    assert set(profiling.SPANS) - opened <= {"sstts.synth.fetch", "sstts.train.scan_graph"}
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)


def test_trace_records_the_fetch_threads(tmp_path, synth):
    """`trace()` profiles every thread: the fetch spans of a stream's pool
    reach its file, on a thread other than the dispatches'."""
    with profiling.trace(tmp_path):
        _stream(synth)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    tids = {name: {e["tid"] for e in events if e.get("name") == name}
            for name in ("sstts.synth.fetch", "sstts.synth.dispatch")}
    assert tids["sstts.synth.fetch"] and tids["sstts.synth.dispatch"]
    assert not tids["sstts.synth.fetch"] & tids["sstts.synth.dispatch"]
    assert sum(e.get("name") == "sstts.synth.fetch" for e in events) == len(BATCHES)
