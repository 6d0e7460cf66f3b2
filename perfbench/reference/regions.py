"""Region discovery, written plainly from the upstream description
(longcallR/src/util.rs:236-332): a contig's depth of QC-passing reads,
column by column; a region is a run of two or more columns whose depth is
above 0 (and, with truncation, at most the truncation coverage). Regions
are 1-based: ``start`` is the run's first column + 1, ``end`` its last + 2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass(frozen=True)
class Region:
    chr: str
    start: int
    end: int


def read_passes(read, cfg) -> bool:
    """The read QC of every BAM pass (util.rs:652-668, fragment.rs:32-49)."""
    if (read.mapq < cfg.min_mapq or read.l_seq < cfg.min_read_length
            or read.is_unmapped or read.is_secondary or read.is_supplementary):
        return False
    de = read.get_tag("de")
    return not (isinstance(de, float) and de >= cfg.divergence)


def discover(bam, fasta_lengths, cfg) -> List[Region]:
    """Every contig's regions, in contig order."""
    out: List[Region] = []
    for chrom, L in fasta_lengths:
        diff = np.zeros(L + 1, np.int64)
        for r in bam.fetch(chrom):
            if r.pos >= L or not read_passes(r, cfg):
                continue
            diff[r.pos] += 1
            diff[min(r.reference_end(), L)] -= 1
        depth = np.cumsum(diff[:L])
        keep = depth > 0
        if cfg.truncation:
            keep &= depth <= cfg.truncation_coverage
        edges = np.flatnonzero(np.diff(np.concatenate([[0], keep.astype(np.int8), [0]])))
        for s, e in zip(edges[0::2], edges[1::2] - 1):
            if e > s:
                out.append(Region(chrom, int(s) + 1, int(e) + 2))
    return out
