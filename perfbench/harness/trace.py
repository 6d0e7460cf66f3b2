"""Reduces the device activity of one profiled pass to what the per-layer
metrics read: the busy time (the union of the intervals in which an
operation ran on the device), the span of the pass on the profiler's own
clock, the device time of each operation by name, and the longest idle
gaps.

The pass is bracketed by two marker operations launched on an idle device
just before it starts and just after it has synchronised, so the first and
the last interval of the trace mark its span."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Interval = Tuple[float, float, str]     # start, end (seconds), name


def merge(intervals: Sequence[Interval]) -> List[List]:
    """The union of the intervals as disjoint groups in time order:
    [start, end, name of the first operation, name of the one that ends
    last]."""
    out: List[List] = []
    for s, e, name in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1], out[-1][3] = e, name
        else:
            out.append([s, e, name, name])
    return out


def reduce(intervals: Sequence[Interval], n_gaps: int = 10) -> Dict:
    """``busy_s``, ``span_s``, ``by_name`` (device seconds by operation
    name) and ``gaps`` ([label, seconds], the ``n_gaps`` longest idle
    stretches, each named by where it lies in the pass and by the
    operations around it)."""
    if not intervals:
        raise ValueError("the profiler saw no device activity")
    groups = merge(intervals)
    t0 = groups[0][0]
    by_name: Dict[str, float] = {}
    for s, e, name in intervals:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps = [[f"{a[1] - t0:.3f} s into the pass, after {a[3][:50]}, "
             f"before {b[2][:50]}", b[0] - a[1]]
            for a, b in zip(groups, groups[1:])]
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": sum(e - s for s, e, _, _ in groups),
            "span_s": groups[-1][1] - t0, "by_name": by_name,
            "gaps": gaps[:n_gaps]}


def device_intervals(prof) -> List[Interval]:
    """Every device operation of a finished ``torch.profiler`` session."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        tr = ev.time_range
        out.append((tr.start * 1e-6, tr.end * 1e-6, ev.name))
    return out
