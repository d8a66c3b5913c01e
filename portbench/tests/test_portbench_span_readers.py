"""The readers of the program's spans, on hand-built traces with known
device gaps and spans: the idle shares under a span name, a gap covered
by nested spans counted once, the idle time outside the device's window
left out, the spans' own lengths, and None where the trace holds no span
of the name (as a program without spans gives)."""

import re

import pytest

from portbench import harness, spans

# Device operations merged: [0, 100], [200, 400], [600, 700]; gaps
# [100, 200] and [400, 600], 300 us of idle time.
EVENTS = [("k", 0.0, 100.0), ("k", 200.0, 300.0), ("k", 250.0, 400.0), ("k", 600.0, 700.0)]
HOST = [
    ("sstts.gl.iter", -50.0, 5.0),  # before the first device operation
    ("sstts.gl.iter", 10.0, 150.0),  # 50 of the first gap
    ("sstts.gl.iter", 380.0, 450.0),  # 50 of the second
    ("sstts.gl.iter", 800.0, 900.0),  # after the last
    ("sstts.gl.edges", 390.0, 420.0),  # nested in an iteration
    ("sstts.synth.wire", 450.0, 650.0),  # 150 of the second gap
    ("sstts.synth.wait", 700.0, 760.0),
    ("sstts.synth.wait", 760.0, 800.0),
    ("sstts.train.backward", 50.0, 650.0),  # both gaps whole
    ("sstts.train.update", 120.0, 130.0),
    ("sstts.train.update", 125.0, 140.0),  # overlaps the one before
    ("aten::mm", 100.0, 200.0),
]
UNITS = [{"B": 32}, {"B": 32}]


def _trace(events=EVENTS, host=HOST):
    return harness.Trace({}, UNITS, 1.0, list(events), list(host), unit_s=0.5)


def _read(name, trace):
    return harness.metric_reader(name)(trace)


@pytest.mark.parametrize("name, want", [
    ("idle_in_gl_pct.synth", 100.0 * 100.0 / 300.0),
    ("idle_in_wire_pct.synth", 100.0 * 150.0 / 300.0),
    ("idle_in_backward_pct.train", 100.0),
    ("idle_in_update_pct.train", 100.0 * 20.0 / 300.0),
])
def test_idle_shares(name, want):
    assert _read(name, _trace()) == pytest.approx(want)


def test_nested_spans_count_once():
    nested = HOST + [("sstts.gl.iter", 20.0, 140.0), ("sstts.gl.iter", 400.0, 449.0)]
    assert _read("idle_in_gl_pct.synth", _trace(host=nested)) == pytest.approx(100.0 / 3.0)
    both = [("x", 0.0, 160.0), ("x", 150.0, 180.0), ("x", 500.0, 550.0)]
    assert spans.idle_covered_pct(_trace(), both) == pytest.approx(100.0 * 130.0 / 300.0)


def test_idle_outside_the_device_window_is_left_out():
    outside = [("sstts.synth.wire", -100.0, 0.0), ("sstts.synth.wire", 700.0, 1e6)]
    assert _read("idle_in_wire_pct.synth", _trace(host=outside)) == 0.0
    one_op = [("k", 0.0, 100.0), ("k", 50.0, 80.0)]
    assert _read("idle_in_wire_pct.synth", _trace(events=one_op)) == 0.0


def test_span_lengths():
    iters = [e - s for n, s, e in HOST if n == "sstts.gl.iter"]
    assert _read("gl_host_ms_per_iter.synth", _trace()) == pytest.approx(
        sum(iters) / len(iters) / 1e3)
    assert _read("stream_wait_ms_per_batch.synth", _trace()) == pytest.approx(0.1 / len(UNITS))


SPAN_METRICS = ("gl_host_ms_per_iter.synth", "idle_in_gl_pct.synth", "idle_in_wire_pct.synth",
                "stream_wait_ms_per_batch.synth", "idle_in_backward_pct.train",
                "idle_in_update_pct.train")


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_without_spans(name):
    """A program without spans (or a trace without device operations for
    the idle shares) reads None, and the result line leaves it out."""
    assert _read(name, _trace(host=[("aten::mm", 100.0, 200.0)])) is None
    if "idle" in name:
        assert _read(name, _trace(events=[])) is None


def test_span_metrics_read_the_programs_names():
    """Each reader names a span the program opens, and each metric is a
    `program_span` of the cells it lists."""
    from sstts_torch.utils.profiling import SPANS

    spec = harness.benchmark_spec()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in SPAN_METRICS:
        src = (harness.BENCH_DIR / "metrics" / f"{name}.py").read_text()
        read = re.findall(r'"(sstts\.[a-z.]+)"', src)
        assert read and set(read) <= set(SPANS), name
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        cells = ["lj22k-train-b32"] if name.endswith(".train") else [
            "lj22k-batch32", "lj22k-serve-fast"]
        assert m["workloads"] == cells


@pytest.mark.parametrize("kind", ["synth_stream", "train_cached"])
def test_a_traced_tiny_run_holds_the_spans(kind):
    """The drivers' traced window holds the program's spans, a batch's or
    a step's each; the spans' lengths read, and the idle shares read None
    on the CPU, which has no device operations."""
    from portbench.tests import tiny

    if kind == "synth_stream":
        traffic = tiny.synth_traffic()
        res = tiny.run(kind, tiny.synth_tree(), traffic, trace=True)
        per_unit = {"sstts.synth.dispatch": 1, "sstts.synth.wait": 1,
                    "sstts.gl.iter": traffic["inference"]["griffin_lim_iters"]}
    else:
        res = tiny.run(kind, tiny.train_tree(), tiny.train_traffic(), trace=True)
        per_unit = {"sstts.train.step": 1, "sstts.train.backward": 1}
    tr = res.trace
    for name, n in per_unit.items():
        assert len(spans.spans(tr, name)) == n * len(tr.units), name
    for name in SPAN_METRICS:
        if name.endswith(".train") != (kind == "train_cached"):
            continue
        value = _read(name, tr)
        assert value is None if "idle" in name else value > 0.0, name
