"""Annotation parsing and gene-region intersection.

Mirrors ``longcallR/src/util.rs:334-452`` (parse_annotation) and
``util.rs:454-556`` (lapper_intervals / intersect_gene_regions):
  * gene features build per-chromosome stacks of merged gene regions
    (overlaps merged, gene_ids comma-joined; input must be sorted);
  * **CDS** features (not ``exon`` — a reference quirk, util.rs:418) build
    per-gene interval lists, stored 1-based with exclusive end;
  * --exon-only splits alignment regions into per-gene intersections.

Copied from ``longcallr_tpu/pipeline/annotation.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..tiles.regions import Region


def _extract_gene_id(attrs: str) -> str:
    for subpart in attrs.rstrip().split(";"):
        t = subpart.strip()
        if t.startswith("gene_id="):     # GFF3
            return t[len("gene_id="):]
        if t.startswith("gene_id "):     # GTF
            return t[len("gene_id "):].strip('"')
    return ""


def parse_annotation(anno_path: str) -> Tuple[Dict[str, List[Region]],
                                              Dict[str, List[Tuple[int, int]]]]:
    """Returns (gene_regions by chr, exon(CDS) intervals by gene_id).
    Intervals are 1-based [start, end+1) like the reference's."""
    gene_regions: Dict[str, List[Region]] = {}
    exon_regions: Dict[str, List[Tuple[int, int]]] = {}
    invs: List[Tuple[int, int]] = []
    gene_id = ""
    with open(anno_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                continue
            seqname = parts[0]
            feature = parts[2]
            start = int(parts[3])  # 1-based inclusive
            end = int(parts[4])    # 1-based inclusive
            if feature == "gene":
                if invs:
                    exon_regions[gene_id] = list(invs)
                    invs.clear()
                gene_id = _extract_gene_id(parts[8])
                stack = gene_regions.setdefault(seqname, [])
                if stack:
                    top = stack[-1]
                    if start < top.start:
                        raise ValueError(
                            f"annotation file is not sorted. {seqname}:{start}-{end}")
                    if top.end <= start:
                        stack.append(Region(chr=seqname, start=start, end=end + 1,
                                            max_coverage=0, gene_id=gene_id))
                    elif top.end < end + 1:
                        top.end = end + 1
                        top.gene_id = (top.gene_id or "") + "," + gene_id
                    else:
                        top.gene_id = (top.gene_id or "") + "," + gene_id
                else:
                    stack.append(Region(chr=seqname, start=start, end=end + 1,
                                        max_coverage=0, gene_id=gene_id))
            elif feature == "CDS":
                exon_gene_id = _extract_gene_id(parts[8])
                if exon_gene_id != gene_id:
                    raise ValueError(
                        f"gene_id in gene and exon differ: {gene_id} vs {exon_gene_id}")
                invs.append((start, end + 1))
    if invs:
        exon_regions[gene_id] = list(invs)
    return gene_regions, exon_regions


def lapper_intervals(query_regions: List[Region], target_regions: List[Region],
                     merge: bool) -> List[Region]:
    """util.rs:454-516: intersect query regions with gene-region intervals."""
    if not target_regions:
        return [] if merge else [
            Region(chr=q.chr, start=q.start, end=q.end,
                   max_coverage=q.max_coverage, gene_id="")
            for q in query_regions]
    starts = np.asarray([t.start for t in target_regions], dtype=np.int64)
    ends = np.asarray([t.end for t in target_regions], dtype=np.int64)
    out: List[Region] = []
    for q in query_regions:
        hits = np.nonzero((starts < q.end) & (ends > q.start))[0]
        if merge:
            for h in hits.tolist():
                t = target_regions[h]
                s = max(q.start, t.start)
                e = min(q.end, t.end)
                if s >= e:
                    raise ValueError(f"intersected_start >= intersected_end: {q}")
                out.append(Region(chr=q.chr, start=int(s), end=int(e),
                                  max_coverage=q.max_coverage,
                                  gene_id=t.gene_id))
        else:
            gene_ids = [target_regions[h].gene_id or "" for h in hits.tolist()]
            out.append(Region(chr=q.chr, start=q.start, end=q.end,
                              max_coverage=q.max_coverage,
                              gene_id=",".join(gene_ids)))
    return out


def intersect_gene_regions(alignment_regions: List[Region],
                           gene_regions: Dict[str, List[Region]],
                           merge: bool = True) -> List[Region]:
    """util.rs:518-556, contig order deterministic."""
    by_chr: Dict[str, List[Region]] = {}
    for r in alignment_regions:
        by_chr.setdefault(r.chr, []).append(r)
    out: List[Region] = []
    for chrom in by_chr:
        if chrom in gene_regions:
            out.extend(lapper_intervals(by_chr[chrom], gene_regions[chrom], merge))
    return out
