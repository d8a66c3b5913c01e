"""Milliseconds a traced batch that the stream spent waiting on its oldest
batch's fetch (the program's `sstts.synth.wait` spans, summed over the
traced window, by the batches it completed): time in which the host
enqueues nothing.  Moves `batch_p95_s`."""

from portbench.spans import spans


def read(trace):
    waits = spans(trace, "sstts.synth.wait")
    if not waits or not trace.units:
        return None
    return sum(e - s for _, s, e in waits) / len(trace.units) / 1e3
