"""The share of the device's idle time in the traced window that falls
under the program's `sstts.train.update` spans: the card waiting while
the host fills, measures and clips the gradients and runs Adam and the
EMA.  Moves `train_utt_per_s`."""

from portbench.spans import idle_under_pct


def read(trace):
    return idle_under_pct(trace, "sstts.train.update")
