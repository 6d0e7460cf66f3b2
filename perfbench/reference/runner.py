"""One region through the reference, in a worker process: what the
comparison needs of it."""

from __future__ import annotations

from typing import Dict, List, Tuple

from . import config as C
from .pipeline import scalar_process_region
from .regions import Region


def call_region(payload) -> Tuple[Region, List[str], Dict[str, int], Dict[str, int]]:
    """``payload``: (preset name, Region, a reader of the region's reads,
    the contig's sequence, settings that replace the preset's). Returns
    the region, its VCF record lines, and each read's haplotype (0: none)
    and phase set."""
    preset, region, bam, ref_seq, changed = payload
    lines, assignments, phase_sets = scalar_process_region(
        bam, region, ref_seq, C.preset(preset).replace(**changed))
    return region, [l.rstrip("\n") for l in lines], assignments, phase_sets
