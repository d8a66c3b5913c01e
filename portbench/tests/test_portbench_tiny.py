"""Both traffic kinds end to end at the program's tiny configuration on
the CPU, through the program's plain paths, against the reference; the
controls read above the program; and a broken program reads `correct`
false.

On the CPU the program's model parts equal the reference's bit for bit;
the Griffin-Lim loop's bf16 rounding points are the same, its f32 sums
are taken in another order (the program's shift-add against an
overlap-add), and flipped bf16 roundings grow over the iterations: 8
iterations read a waveform gap near 1e-2 (the limits below leave room
over it).  The train step runs in float32 on both sides (the program's
teacher scan is f32 on the CPU)."""

import pytest
import torch

from portbench import check
from portbench.tests import tiny

SYNTH_TOL = {"wave_rel": 5e-2, "mag_rel": 2e-2, "band_rel": 2e-2, "band_db": 3.0}
TRAIN_TOL = {"loss_gap": 1e-5, "grad_gap": 1e-4, "update_gap": 1e-3}


@pytest.mark.parametrize("traffic", ["stream_b32", "stream_b32_fast"])
def test_synthesis_agrees(traffic):
    res = tiny.run("synth_stream", tiny.synth_tree(), tiny.synth_traffic(traffic),
                   limits={"limits": SYNTH_TOL})
    assert res.failed == 0 and res.attempted > 0
    assert res.e2e["audio_rtf"] > 0 and res.e2e["batch_p95_s"] > 0
    assert check.passed(res.checks), res.checks


def test_synthesis_trace_units():
    res = tiny.run("synth_stream", tiny.synth_tree(), tiny.synth_traffic(), trace=True)
    assert len(res.trace.units) == 3
    assert {u["S"] for u in res.trace.units} == {40}
    # The untraced window runs first and gives the wall time a batch.
    assert res.trace.unit_s > 0 and res.e2e["audio_rtf"] > 0


def test_train_trace_units():
    res = tiny.run("train_cached", tiny.train_tree(), tiny.train_traffic(), trace=True)
    assert len(res.trace.units) == 2
    assert res.trace.unit_s > 0 and res.e2e["train_utt_per_s"] > 0


def test_train_agrees():
    res = tiny.run("train_cached", tiny.train_tree(), tiny.train_traffic(),
                   limits={"limits": TRAIN_TOL})
    assert res.attempted > 0 and res.e2e["train_utt_per_s"] > 0
    assert check.passed(res.checks), res.checks


def test_controls_read_above():
    from portbench.drivers import synth_stream, train_cached

    for name, gaps in synth_stream.control(tiny.synth_tree(), tiny.synth_traffic(), 5, "cpu"):
        assert gaps["mag_rel"] > 3 * SYNTH_TOL["mag_rel"], (name, gaps)
    for name, gaps in train_cached.control(tiny.train_tree(), tiny.train_traffic(), 5, "cpu"):
        assert max(gaps[k] / TRAIN_TOL[k] for k in gaps) > 3, (name, gaps)


def _altered_wire(monkeypatch):
    from sstts_torch.dsp import ops

    orig = ops.encode_wire

    def altered(wav, fmt):  # an answer altered where it is produced
        return orig(wav * 0.5, fmt)

    monkeypatch.setattr(ops, "encode_wire", altered)


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from sstts_torch import train

    orig = train._gather

    def half(corpus, keys, idx, valid):  # half the rows left out, the mean over the rest
        b = orig(corpus, keys, idx, valid)
        lf = b["loss_frames"].clone()
        lf[: lf.shape[0] // 2] = 0
        b["loss_frames"] = lf
        return b

    monkeypatch.setattr(train, "_gather", half)


@pytest.mark.parametrize("fault", ["altered_wire"])
def test_synthesis_fault_fails(monkeypatch, fault):
    _altered_wire(monkeypatch)
    res = tiny.run("synth_stream", tiny.synth_tree(), tiny.synth_traffic(),
                   limits=check_limits("lj22k-batch32", SYNTH_TOL))
    assert not check.passed(res.checks), res.checks


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_train_fault_fails(monkeypatch, fault):
    {"unchanged_state": _unchanged_state, "half_batch": _half_batch}[fault](monkeypatch)
    res = tiny.run("train_cached", tiny.train_tree(), tiny.train_traffic(),
                   limits=check_limits("lj22k-train-b32", TRAIN_TOL))
    assert not check.passed(res.checks), res.checks


def check_limits(cell, fallback):
    """The cell's own limits where they are set (the faults must fail
    them), else the tiny tolerances."""
    from portbench import harness

    lim = harness.limits_file(cell)["limits"]
    return {"limits": {k: (v if v is not None else fallback[k]) for k, v in lim.items()}}
