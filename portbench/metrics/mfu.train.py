"""The whole train step's share of the chip's peak: the least device time
of a step's forward and backward (`yardstick.train_step_seconds`) over the
wall seconds a step of the run's untraced window, in percent.  Moves
`train_utt_per_s`."""

from portbench import yardstick


def read(trace):
    if not trace.units or not trace.unit_s:
        return None
    ideal = sum(yardstick.train_step_seconds(trace.cfg, u["B"], u["T"], u["F"])
                for u in trace.units) / len(trace.units)
    return 100.0 * ideal / trace.unit_s
