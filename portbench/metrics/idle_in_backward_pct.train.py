"""The share of the device's idle time in the traced window that falls
under the program's `sstts.train.backward` spans: the card waiting while
the host runs `loss.backward()` (autograd's replay of the f32 scan
included).  Moves `train_utt_per_s`."""

from portbench.spans import idle_under_pct


def read(trace):
    return idle_under_pct(trace, "sstts.train.backward")
