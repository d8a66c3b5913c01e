"""B4's share of its roofline: the frozen bound of each batch's decode
(`yardstick.b4_bound`) over the device time of fused_decode_kernel, in
percent.  Moves `audio_rtf`."""

import re

from portbench import yardstick

_NAME = re.compile(r"\bfused_decode_kernel\b")


def read(trace):
    seconds, n = trace.device_seconds(_NAME)
    if n == 0 or seconds <= 0:
        return None
    a, m = trace.cfg["arch"], trace.cfg["dataset"]["n_mels"]
    bound_ms = sum(yardstick.b4_bound(a, m, u["B"], u["T"], u["S"])[0] for u in trace.units)
    return 100.0 * bound_ms / 1e3 / seconds
