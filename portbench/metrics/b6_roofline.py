"""B6's share of its roofline: the frozen bound of each step's
teacher-forced scan forward (`yardstick.b6_bound`) over the device time of
teacher_scan_kernel, in percent.  Moves `train_utt_per_s`."""

import re

from portbench import yardstick

_NAME = re.compile(r"\bteacher_scan_kernel\b")


def read(trace):
    seconds, n = trace.device_seconds(_NAME)
    if n == 0 or seconds <= 0:
        return None
    a, m = trace.cfg["arch"], trace.cfg["dataset"]["n_mels"]
    r = a["reduction_factor"]
    bound_ms = sum(yardstick.b6_bound(a, m, u["B"], u["T"], u["F"] // r)[0]
                   for u in trace.units)
    return 100.0 * bound_ms / 1e3 / seconds
