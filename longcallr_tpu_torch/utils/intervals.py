"""Minimal interval-overlap index (replaces the intervaltree dependency of
the reference analysis scripts, longcallR-ase.py:6 / longcallR-asj.py).

Copied from ``longcallr_tpu/utils/intervals.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def merge_intervals(ivs: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge overlapping [start, end) intervals (IntervalTree.merge_overlaps
    semantics: touching intervals are NOT merged unless overlapping)."""
    ivs = sorted(ivs)
    out: List[Tuple[int, int]] = []
    for s, e in ivs:
        if out and s < out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class IntervalIndex:
    """Static overlap queries over [start, end) intervals with payloads."""

    def __init__(self, intervals: Sequence[Tuple[int, int]], data=None):
        order = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
        self.starts = np.asarray([intervals[i][0] for i in order], dtype=np.int64)
        self.ends = np.asarray([intervals[i][1] for i in order], dtype=np.int64)
        self.data = [None if data is None else data[i] for i in order]
        # running max of ends enables early cut-off scans
        self.max_ends = np.maximum.accumulate(self.ends) if len(order) else self.ends

    def __len__(self) -> int:
        return len(self.data)

    def overlap(self, qs: int, qe: int) -> List[int]:
        """Indices of intervals overlapping [qs, qe)."""
        n = self.starts.shape[0]
        if n == 0 or qs >= qe:
            return []
        hi = int(np.searchsorted(self.starts, qe, side="left"))
        out = []
        for i in range(hi - 1, -1, -1):
            if self.max_ends[i] <= qs:
                break
            if self.ends[i] > qs:
                out.append(i)
        out.reverse()
        return out

    def overlap_data(self, qs: int, qe: int) -> List:
        return [self.data[i] for i in self.overlap(qs, qe)]

    # NOTE: no half-open overlap_length variant on purpose — production
    # exon-overlap sums must use overlap_length_ref below, which replicates
    # the reference's closed-segment quirk (an exon starting exactly at a
    # segment's last base counts 0); a clean half-open sum diverges from
    # longcallR-ase.py:249-253 (caught by the analysis fuzz gate).

    def overlap_length_ref(self, a: int, b: int) -> int:
        """The reference's splice-segment exon-overlap sum over a CLOSED
        segment [a, b] (longcallR-ase.py:249-253 / longcallR-asj.py:264-268):
        candidate intervals come from ``tree.overlap(a, b)`` — a HALF-OPEN
        [a, b) query, so an exon starting exactly at the segment's last base
        is (quirkily) excluded — then each contributes the closed-interval
        overlap ``min(b, end-1) - max(a, start) + 1``."""
        total = 0
        for i in self.overlap(a, b):
            total += max(0, min(b, int(self.ends[i]) - 1)
                         - max(a, int(self.starts[i])) + 1)
        return total
