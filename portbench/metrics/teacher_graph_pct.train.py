"""The share (percent) of B6's backwards in the traced window that replay
a captured CUDA graph: the program's `sstts.train.scan_graph` spans over
its `sstts.train.scan_grad` spans, one of which opens for every backward
of the teacher-forced scan whatever its route.  None without
`scan_grad` spans (a program without them).  Moves `train_utt_per_s`:
an eager backward issues the f32 scan's rerun one launch at a time."""

from portbench.spans import spans


def read(trace):
    grads = spans(trace, "sstts.train.scan_grad")
    if not grads:
        return None
    return 100.0 * len(spans(trace, "sstts.train.scan_graph")) / len(grads)
