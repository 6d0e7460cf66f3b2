"""Decides ``correct``: what the timed passes wrote, against the plain
reference.

* Region discovery over the whole input: every VCF record of the program
  has to lie in a region that the reference discovers (``stray_records``).
* A sample of regions drawn from the seed, a region of every class of
  size (reads and span) among them, runs through the reference in worker
  processes. In each, the program's VCF records (position, alleles,
  genotype with its phase, QUAL, GQ, FILTER, PS and the rest of the line)
  have to equal the reference's, line for line (``record_diffs``), and
  every read that the phased BAM holds for the region has to carry the
  reference's HP and PS tags (``tag_diffs``).
* Every pass of the window has to have written the same VCF records and
  the same HP and PS tags on the same reads (``pass_diffs``).

Each is a count of differences, with the limit 0.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from reference.regions import Region, discover
from reference.runner import call_region
from reference import config as RC

from . import bamio

LIMITS = {"stray_records": 0, "record_diffs": 0, "tag_diffs": 0,
          "pass_diffs": 0}


def vcf_records(path: str) -> List[str]:
    with open(path) as f:
        return [l.rstrip("\n") for l in f if not l.startswith("#")]


def _in(region: Region, line: str) -> bool:
    chrom, pos = line.split("\t", 2)[:2]
    return chrom == region.chr and region.start <= int(pos) <= region.end


def _bucket(n: int) -> int:
    """The power of two at or above ``n``."""
    return 1 << max(0, int(n) - 1).bit_length()


def sample(regions: List[Region], sizes: List[Tuple[int, int]], seed: int,
           n: int) -> List[Region]:
    """A sample of ``regions`` drawn from the seed that holds a region of
    every class of (reads, span), each rounded up to a power of two, which
    is how the program sizes its buckets, and at least ``n`` regions.
    ``sizes`` holds each region's (reads, span)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    classes: Dict[Tuple[int, int], List[int]] = {}
    for i, (reads, span) in enumerate(sizes):
        classes.setdefault((_bucket(reads), _bucket(span)), []).append(i)
    pick = {int(rng.choice(members)) for _, members in sorted(classes.items())}
    rest = [i for i in range(len(regions)) if i not in pick]
    if len(pick) < n and rest:
        pick |= {int(i) for i in rng.choice(rest, size=min(n - len(pick), len(rest)),
                                             replace=False)}
    return [regions[i] for i in sorted(pick)]


def tagged_reads(bam: bamio.BamReader, region: Region):
    """The reads whose records the phased BAM carries for ``region``:
    primary, mapped, and inside it by the upstream +1 boundaries
    (thread.rs:340-345)."""
    for r in bam.fetch(region.chr, region.start - 1, region.end):
        if r.is_unmapped or r.is_secondary or r.is_supplementary:
            continue
        if r.pos + 1 >= region.start and r.reference_end() + 1 <= region.end:
            yield r


def region_sizes(bam: bamio.BamReader, regions: List[Region]
                 ) -> List[Tuple[int, int]]:
    """(the reads that ``tagged_reads`` yields, the span) of each region,
    from one pass over the reads."""
    spans: Dict[str, List[Tuple[int, int]]] = {}
    for r in bam:
        if not (r.is_unmapped or r.is_secondary or r.is_supplementary):
            spans.setdefault(bam.references[r.ref_id], []).append(
                (r.pos + 1, r.reference_end() + 1))
    arr = {c: np.array(v, dtype=np.int64) for c, v in spans.items()}
    out = []
    for rg in regions:
        a = arr.get(rg.chr, np.zeros((0, 2), np.int64))
        n = int(((a[:, 0] >= rg.start) & (a[:, 1] <= rg.end)).sum())
        out.append((n, rg.end - rg.start + 1))
    return out


def reference_calls(bam_path: str, fasta_path: str, preset: str, seed: int,
                    n_regions: int, workers: int, variants=({},)):
    """(every region the reference discovers; for each of ``variants``,
    settings that replace the preset's, the reference's calls of a sample
    of them drawn from the seed; the input reader)."""
    bam = bamio.BamReader(bam_path)
    fasta = bamio.read_fasta(fasta_path)
    regions = discover(bam, [(n, len(s)) for n, s in fasta.items()],
                       RC.preset(preset))
    picked = sample(regions, region_sizes(bam, regions), seed, n_regions)
    payloads = [(preset, rg, bam.subset(rg.chr, rg.start - 1, rg.end),
                 fasta[rg.chr], v) for v in variants for rg in picked]
    if workers > 1 and len(payloads) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(payloads))) as pool:
            calls = pool.map(call_region, payloads, chunksize=1)
            pool.close()
            pool.join()
    else:
        calls = [call_region(p) for p in payloads]
    n = len(picked)
    return regions, [calls[i * n:(i + 1) * n] for i in range(len(variants))], bam


def pass_digest(prefix: str) -> str:
    """A digest of what one pass wrote: its VCF records, and the (name, HP,
    PS) of every read of its phased BAM, in name order."""
    h = hashlib.sha256()
    for line in vcf_records(prefix + ".vcf"):
        h.update(line.encode() + b"\n")
    tags = sorted((r.qname, r.get_tag("HP") or 0, r.get_tag("PS") or 0)
                  for r in bamio.BamReader(prefix + ".phased.bam"))
    h.update(repr(tags).encode())
    return h.hexdigest()


def compare_calls(calls, control, bam) -> Dict[str, int]:
    """The counts of ``LIMITS`` for ``control``, the calls of the same
    regions by the reference under a broken guarantee, put in the
    program's place."""
    records = [l for _, lines, _, _ in control for l in lines]
    tags = {}
    for region, _, assignments, phase_sets in control:
        for r in tagged_reads(bam, region):
            tags[r.qname] = (assignments.get(r.qname) or None,
                             phase_sets.get(r.qname))
    return _count(records, tags, [], calls, [c[0] for c in calls], bam)


def compare(prefix: str, pass_digests: List[str], regions, calls, bam
            ) -> Dict[str, int]:
    """The counts of ``LIMITS`` for the outputs at ``prefix``."""
    records = vcf_records(prefix + ".vcf")
    phased = bamio.BamReader(prefix + ".phased.bam")
    tags = {r.qname: (r.get_tag("HP"), r.get_tag("PS")) for r in phased}
    return _count(records, tags, pass_digests, calls, regions, bam)


def _count(records, tags, pass_digests, calls, regions, bam) -> Dict[str, int]:
    by_chr: Dict[str, List[Region]] = {}
    for rg in regions:
        by_chr.setdefault(rg.chr, []).append(rg)
    stray = sum(1 for l in records
                if not any(_in(rg, l) for rg in by_chr.get(l.split("\t", 1)[0], [])))
    record_diffs = tag_diffs = 0
    for region, lines, assignments, phase_sets in calls:
        mine = [l for l in records if _in(region, l)]
        if mine != lines:
            record_diffs += len(set(mine) ^ set(lines)) or 1
        for r in tagged_reads(bam, region):
            hp = assignments.get(r.qname) or None
            if tags.get(r.qname) != (hp, phase_sets.get(r.qname)):
                tag_diffs += 1
    last = pass_digests[-1] if pass_digests else None
    return {"stray_records": stray, "record_diffs": record_diffs,
            "tag_diffs": tag_diffs,
            "pass_diffs": sum(1 for d in pass_digests if d != last)}
