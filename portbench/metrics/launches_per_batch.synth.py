"""Device operations (kernels, copies, sets) per synthesis batch in the
traced window, from torch.profiler.  Moves `audio_rtf`: each launch costs
the host its dispatch."""


def read(trace):
    if not trace.units or not trace.events:
        return None
    return len(trace.events) / len(trace.units)
