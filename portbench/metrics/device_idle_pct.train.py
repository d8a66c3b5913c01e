"""The device's idle share: 100 (1 - the device's busy seconds a unit /
the wall seconds a unit), the busy seconds the union of the device
operations' intervals over the traced window by the units it completed,
the wall seconds those of the run's untraced window, which the
profiler's cost on the host does not stretch."""


def read(trace):
    if not trace.events or not trace.units or not trace.unit_s:
        return None
    return 100.0 * (1.0 - trace.busy_s() / len(trace.units) / trace.unit_s)
