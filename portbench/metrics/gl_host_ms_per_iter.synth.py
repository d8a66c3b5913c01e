"""The host's milliseconds a Griffin-Lim iteration under the profiler: the
mean length of the program's `sstts.gl.iter` spans in the traced window,
each from the iteration's first launch call to the return of its last
(the edge repair's included).  The profiler stretches the host's time.
Moves `audio_rtf`: in the host-bound cells the iterations' dispatch is
most of a batch."""

from portbench.spans import spans


def read(trace):
    iters = spans(trace, "sstts.gl.iter")
    if not iters:
        return None
    return sum(e - s for _, s, e in iters) / len(iters) / 1e3
