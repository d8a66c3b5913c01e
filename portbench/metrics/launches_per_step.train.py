"""Device operations (kernels, copies, sets) per train step in the traced
window, from torch.profiler.  Moves `train_utt_per_s`."""


def read(trace):
    if not trace.units or not trace.events:
        return None
    return len(trace.events) / len(trace.units)
