"""The share of the device's idle time in the traced window that falls
under the program's `sstts.synth.wire` spans: the card waiting while the
host dispatches the wire's encode (one op for PCM16, the ADPCM encoder's
loop for adpcm4).  Moves `audio_rtf`."""

from portbench.spans import idle_under_pct


def read(trace):
    return idle_under_pct(trace, "sstts.synth.wire")
