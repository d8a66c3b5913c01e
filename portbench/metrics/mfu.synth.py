"""The whole synthesis batch's share of the chip's peak: the least device
time of a traced batch's work (`yardstick.synth_batch_seconds`: each
part's operations over the peak of its stated precision), averaged over
the traced batches, over the wall seconds a batch of the run's untraced
window, in percent.  Moves `audio_rtf`."""

from portbench import yardstick


def read(trace):
    if not trace.units or not trace.unit_s:
        return None
    ideal = sum(yardstick.synth_batch_seconds(trace.cfg, u["B"], u["T"], u["S"])
                for u in trace.units) / len(trace.units)
    return 100.0 * ideal / trace.unit_s
