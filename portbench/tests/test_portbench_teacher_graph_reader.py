"""The reader of `teacher_graph_pct.train` on hand-built traces: four
backwards of B6, three of them replays of a captured graph, read 75%; a
trace without `sstts.train.scan_grad` spans (a program without them)
reads None.  The reader names spans the program opens, and its entry is
a `program_span` of the train cell."""

import re

from portbench import harness

EVENTS = [("k", 0.0, 100.0), ("k", 200.0, 300.0)]
GRADS = [("sstts.train.scan_grad", s, s + 60.0) for s in (10.0, 200.0, 400.0, 600.0)]
REPLAYS = [("sstts.train.scan_graph", s + 20.0, s + 50.0) for s in (200.0, 400.0, 600.0)]


def _read(host, events=EVENTS):
    trace = harness.Trace({}, [{"B": 32}] * 4, 1.0, list(events), list(host))
    return harness.metric_reader("teacher_graph_pct.train")(trace)


def test_replays_over_backwards():
    assert _read(GRADS + REPLAYS + [("aten::mm", 0.0, 1.0)]) == 75.0
    assert _read(GRADS) == 0.0
    assert _read(GRADS + REPLAYS, events=[]) == 75.0  # counts spans, not device time


def test_none_without_scan_grad_spans():
    assert _read([("aten::mm", 0.0, 1.0)]) is None
    assert _read(REPLAYS) is None


def test_the_entry_reads_the_programs_spans():
    from sstts_torch.utils.profiling import SPANS

    src = (harness.BENCH_DIR / "metrics" / "teacher_graph_pct.train.py").read_text()
    names = set(re.findall(r'"(sstts\.[a-z._]+)"', src))
    assert names == {"sstts.train.scan_grad", "sstts.train.scan_graph"} <= set(SPANS)
    m = {m["name"]: m for m in harness.benchmark_spec()["per_layer"]}["teacher_graph_pct.train"]
    assert (m["unit"], m["source"], m["better"], m["layer"], m["moves"], m["workloads"]) == (
        "%", "program_span", "higher", "train", "train_utt_per_s", ["lj22k-train-b32"])
