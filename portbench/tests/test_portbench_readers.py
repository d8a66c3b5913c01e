"""The per-layer readers and the reference's rounding: the readers of a
unit's time take the untraced window's, the kernel-bound cells' readers
read as their models, and a float8 operand keeps its range."""

import pytest
import torch

from portbench import harness
from portbench.reference import CONTROL_ALL, STATED, matmul_precision, round_to


def _trace(unit_s):
    cfg = harness.config_tree(__import__("sstts_torch.config", fromlist=["Config"]).Config())
    units = [{"B": 32, "T": 160, "S": 162, "F": 810, "audio_s": 211.0}] * 4
    events = [("gl_semi_kernel", 0.0, 500.0), ("fused_decode_kernel", 1000.0, 10000.0),
              ("gl_semi_kernel", 20000.0, 20500.0)]
    return harness.Trace(cfg, units, 1.0, events, [], unit_s=unit_s)


def test_unit_time_readers():
    tr = _trace(0.25)
    idle = harness.metric_reader("device_idle_pct.synth")(tr)
    assert idle == pytest.approx(100.0 * (1.0 - tr.busy_s() / 4 / 0.25))
    mfu = harness.metric_reader("mfu.synth")(tr)
    assert mfu == pytest.approx(2.0 * harness.metric_reader("mfu.synth")(_trace(0.5)))
    for name in ("device_idle_pct.synth", "mfu.synth", "mfu.train", "device_idle_pct.train"):
        assert harness.metric_reader(name)(_trace(None)) is None


@pytest.mark.parametrize("base", ["launches_per_batch.synth", "mfu.synth", "b2_roofline",
                                  "b4_roofline", "device_idle_pct.synth"])
def test_kernel_bound_readers(base):
    name = base.removesuffix(".synth") + ".kernel_bound"
    tr = _trace(0.25)
    assert harness.metric_reader(name)(tr) == harness.metric_reader(base)(tr)
    spec = harness.benchmark_spec()
    moves = {m["name"]: m["moves"] for m in spec["per_layer"]}
    assert moves[name] == "audio_rtf.kernel_bound"


def test_e2e_value():
    e2e = {"audio_rtf": 2.0, "batch_p95_s": 0.3}
    assert harness.e2e_value(e2e, "audio_rtf.kernel_bound") == 2.0
    assert harness.e2e_value({**e2e, "audio_rtf.kernel_bound": 3.0},
                             "audio_rtf.kernel_bound") == 3.0
    assert harness.e2e_value(e2e, "batch_p95_s") == 0.3


def test_round_to_float8_keeps_range():
    x = torch.logspace(-3, 4, 200) * torch.where(torch.arange(200) % 2 == 0, 1.0, -1.0)
    y = round_to(x, torch.float8_e4m3fn)
    assert torch.isfinite(y).all()
    big = x.abs() > 1e4 * 2.0 ** -6  # normal range under one scale for the tensor
    assert ((y - x).abs() <= x.abs() / 16)[big].all()
    assert (y[big] != x[big]).any()
    assert torch.equal(round_to(x, torch.bfloat16), x.to(torch.bfloat16).float())


def test_matmul_precision_flags():
    saved = torch.backends.cuda.matmul.allow_tf32
    with matmul_precision(CONTROL_ALL):
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    with matmul_precision(STATED):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 == saved
