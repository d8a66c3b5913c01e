"""The program's spans in a traced window: the host intervals that
`sstts_torch.utils.profiling.span` marks by name, and the share of the
device's idle time that they cover.

The device's idle time is the gaps between the merged device operations of
the window, from its first operation to its last.  A gap, or the part of
one, that several spans of a name cover (nested or overlapping) counts once.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from portbench.harness import Trace, merged_intervals


def spans(trace: Trace, name: str) -> List[Tuple[str, float, float]]:
    """The host spans named `name`, as (name, start_us, end_us)."""
    return [h for h in trace.host_spans if h[0] == name]


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """(start_us, end_us) of each gap between merged device operations."""
    busy = merged_intervals(trace.events)
    return [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]


def idle_covered_pct(trace: Trace, covering) -> Optional[float]:
    """The share of the device's idle time (percent) that the union of
    `covering`, (name, start_us, end_us) intervals, covers; None without
    intervals or device operations."""
    if not covering or not trace.events:
        return None
    gaps = idle_gaps(trace)
    total = sum(e - s for s, e in gaps)
    if total <= 0.0:
        return 0.0
    cover = merged_intervals(covering)
    covered, j = 0.0, 0
    for s, e in gaps:
        while j < len(cover) and cover[j][1] <= s:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < e:
            covered += min(e, cover[k][1]) - max(s, cover[k][0])
            k += 1
    return 100.0 * covered / total


def idle_under_pct(trace: Trace, name: str) -> Optional[float]:
    """The share of the device's idle time (percent) under spans `name`."""
    return idle_covered_pct(trace, spans(trace, name))
