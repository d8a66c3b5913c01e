"""The frozen bounds reproduce the kernel table's bound column at its
shapes (B2 32 x 800 frames; B3 b=32, T=800, D=H=128; B3' T=515; B4 b=32,
T=96, S=160; B6 b=32, T=128, S=103; the default Config())."""

import dataclasses

import pytest

from portbench import yardstick


@pytest.fixture(scope="module")
def cfg():
    from sstts_torch.config import Config

    return dataclasses.asdict(Config())


@pytest.mark.parametrize("kernel, expected, by", [
    ("B2", 0.1167, "operations"),
    ("B3", 0.0751, "operations"),
    ("B3'", 0.0303, "bytes"),
    ("B4", 0.0174, "operations"),
    ("B6", 0.0103, "operations"),
])
def test_bound_column(cfg, kernel, expected, by):
    a = cfg["arch"]
    ds = cfg["dataset"]
    lo, w_len = yardstick.support(ds["n_fft"], yardstick.win_len(ds))
    assert (lo, w_len) == (474, 1101)
    ms, why = {
        "B2": lambda: yardstick.b2_bound(32, 800, w_len, yardstick.gl_lanes(ds["n_fft"])),
        "B3": lambda: yardstick.b3_bound(32, 800, 128, 128),
        "B3'": lambda: yardstick.b3_backward_bound(32, 515, 128),
        "B4": lambda: yardstick.b4_bound(a, ds["n_mels"], 32, 96, 160),
        "B6": lambda: yardstick.b6_bound(a, ds["n_mels"], 32, 128, 103),
    }[kernel]()
    assert round(ms, 4) == expected and why == by


def test_whole_batch_work(cfg):
    # The least device time of a batch is the sum of its parts at their peaks.
    s = yardstick.synth_batch_seconds(cfg, 32, 160, 162)
    gl = yardstick.gl_ops(cfg["dataset"], 32, 810, 60)
    assert gl["bf16"] / yardstick.PEAK_OPS["bf16"] < s < 2 * gl["bf16"] / yardstick.PEAK_OPS["bf16"]
    assert 0 < yardstick.train_step_seconds(cfg, 32, 128, 515) < s
