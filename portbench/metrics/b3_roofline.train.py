"""B3's and B3''s share of their roofline in training: the frozen bounds
of each step's four GRU sequence forwards (encoder and post-net, both
directions, `yardstick.b3_bound`) and four gradients
(`yardstick.b3_backward_bound`) over the device time of the GRU kernels
(gru_input_proj, gru_fwd_*, gru_bwd_*, gru_pack_grid), in percent.  Moves
`train_utt_per_s`."""

import re

from portbench import yardstick

_NAME = re.compile(r"\bgru_(input_proj|fwd_\w+|bwd_\w+|pack_grid)\b")


def read(trace):
    seconds, n = trace.device_seconds(_NAME)
    if n == 0 or seconds <= 0:
        return None
    a = trace.cfg["arch"]
    ms = 0.0
    for u in trace.units:
        for T, D, H in ((u["T"], a["encoder_highway_units"], a["encoder_gru_units"]),
                        (u["F"], a["post_highway_units"], a["post_gru_units"])):
            ms += 2 * yardstick.b3_bound(u["B"], T, D, H)[0]
            ms += 2 * yardstick.b3_backward_bound(u["B"], T, H)[0]
    return 100.0 * ms / 1e3 / seconds
