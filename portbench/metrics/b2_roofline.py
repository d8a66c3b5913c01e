"""B2's share of its roofline: the frozen bound of every launch the
window's batches need (griffin_lim_iters a batch, `yardstick.b2_bound`)
over the device time of the kernels named gl_semi_kernel and
gl_semi_wide_kernel, in percent.  Moves `audio_rtf`."""

import re

from portbench import yardstick

_NAME = re.compile(r"\bgl_semi(_wide)?_kernel\b")


def read(trace):
    seconds, n = trace.device_seconds(_NAME)
    if n == 0 or seconds <= 0:
        return None
    ds, iters = trace.cfg["dataset"], trace.cfg["inference"]["griffin_lim_iters"]
    _, w_len = yardstick.support(ds["n_fft"], yardstick.win_len(ds))
    hp = yardstick.gl_lanes(ds["n_fft"])
    bound_ms = sum(iters * yardstick.b2_bound(u["B"], u["F"], w_len, hp)[0]
                   for u in trace.units)
    return 100.0 * bound_ms / 1e3 / seconds
