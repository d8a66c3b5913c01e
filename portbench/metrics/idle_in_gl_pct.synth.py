"""The share of the device's idle time in the traced window that falls
under the program's `sstts.gl.iter` spans: the card waiting while the
host dispatches a Griffin-Lim iteration.  Moves `audio_rtf`."""

from portbench.spans import idle_under_pct


def read(trace):
    return idle_under_pct(trace, "sstts.gl.iter")
