"""Synthetic diploid read simulator used as ground truth for golden tests.

Generates a random reference, plants het/hom SNPs on two haplotypes, and
simulates spliced long reads with base errors, indels, soft clips and aux
tags (de, ts), written through the package's own BAM writer.

Copied from ``tests/simulate.py`` (which writes through the JAX package's
BAM writer): the smoke run and the golden workloads of the torch port need
the same simulator without importing that package. Only the imports differ.
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io import bam as bamio
from ..io.fasta import write_fasta

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclass
class Truth:
    ref: bytes
    het_snps: Dict[int, Tuple[int, int]] = field(default_factory=dict)  # pos0 → (ref, alt)
    hom_snps: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    # triallelic: pos0 → (ref, alt1 on hap1, alt2 on hap2) with alt1 != alt2
    tri_snps: Dict[int, Tuple[int, int, int]] = field(default_factory=dict)
    hap_of_read: Dict[str, int] = field(default_factory=dict)           # qname → 1|2
    # phase convention: hap1 carries ALT at every het site


def make_reference(rng: np.random.Generator, length: int = 8000) -> np.ndarray:
    return BASES[rng.integers(0, 4, size=length)]


def plant_snps(rng: np.random.Generator, ref: np.ndarray, n_het: int = 10,
               n_hom: int = 3, lo: int = 500, hi: Optional[int] = None,
               min_gap: int = 120, n_tri: int = 0) -> Truth:
    hi = hi if hi is not None else len(ref) - 500
    positions: List[int] = []
    cursor = lo
    while cursor < hi and len(positions) < n_het + n_hom + n_tri:
        positions.append(int(cursor + rng.integers(0, min_gap // 2)))
        cursor += min_gap
    rng.shuffle(positions)
    truth = Truth(ref=bytes(ref))
    for j, p in enumerate(positions):
        refb = int(ref[p])
        altb = int(BASES[(list(BASES).index(refb) + int(rng.integers(1, 4))) % 4])
        if j < n_het:
            truth.het_snps[p] = (refb, altb)
        elif j < n_het + n_hom:
            truth.hom_snps[p] = (refb, altb)
        else:
            others = [int(b) for b in BASES.tolist() if b not in (refb, altb)]
            alt2 = others[int(rng.integers(0, 2))]
            truth.tri_snps[p] = (refb, altb, alt2)
    return truth


def haplotype_seq(truth: Truth, ref: np.ndarray, hap: int) -> np.ndarray:
    seq = ref.copy()
    for p, (_, alt) in truth.hom_snps.items():
        seq[p] = alt
    for p, (_, a1, a2) in truth.tri_snps.items():
        seq[p] = a1 if hap == 1 else a2
    if hap == 1:
        for p, (_, alt) in truth.het_snps.items():
            seq[p] = alt
    return seq


def simulate_bam(path: str, rng: np.random.Generator, ref: np.ndarray,
                 truth: Truth, n_reads: int = 60, read_len: int = 3000,
                 err_rate: float = 0.002, contig: str = "chrS",
                 with_introns: bool = False, baseq: int = 30,
                 softclip: int = 0, ts_tags: bool = True,
                 biased_sites: Optional[Dict[int, int]] = None) -> None:
    """Simulate reads and write a coordinate-sorted BAM (+ FASTA alongside).

    ``biased_sites``: pos0 → alt base code; the alt is written on
    PLUS-strand reads only (both haplotypes), creating the single-strand
    alt support the strand-bias filter rejects (candidate.rs:199-234).
    Only supported on plain-M reads (no introns/softclips)."""
    if biased_sites:
        assert not with_introns and not softclip, \
            "biased_sites assumes plain M-cigar reads"
    L = len(ref)
    haps = {1: haplotype_seq(truth, ref, 1), 2: haplotype_seq(truth, ref, 2)}
    reads = []
    for i in range(n_reads):
        hap = int(rng.integers(1, 3))
        span = min(read_len, L - 1)
        pos = int(rng.integers(0, max(1, L - span)))
        hseq = haps[hap][pos:pos + span].copy()
        # base errors
        errs = rng.random(span) < err_rate
        if errs.any():
            hseq[errs] = BASES[rng.integers(0, 4, size=int(errs.sum()))]
        if biased_sites and i % 2 == 0:   # plus-strand reads (see below)
            for bp, alt in biased_sites.items():
                if pos <= bp < pos + span:
                    hseq[bp - pos] = alt
        quals = np.full(span, baseq, dtype=np.uint8)
        cigar_items: List[Tuple[int, str]] = []
        if with_introns and span > 900 and rng.random() < 0.5:
            third = span // 3
            intron = int(rng.integers(50, 200))
            # read covers [pos, pos+third) + intron gap + rest
            left = hseq[:third]
            right = haps[hap][pos + third + intron: pos + third + intron + (span - third)]
            right = right.copy()
            e2 = rng.random(len(right)) < err_rate
            if e2.any():
                right[e2] = BASES[rng.integers(0, 4, size=int(e2.sum()))]
            hseq = np.concatenate([left, right])
            quals = np.full(len(hseq), baseq, dtype=np.uint8)
            cigar_items = [(third, "M"), (intron, "N"), (len(right), "M")]
        else:
            cigar_items = [(span, "M")]
        if softclip:
            sc = BASES[rng.integers(0, 4, size=softclip)]
            hseq = np.concatenate([sc, hseq, sc])
            quals = np.concatenate([np.full(softclip, 5, np.uint8), quals,
                                    np.full(softclip, 5, np.uint8)])
            cigar_items = [(softclip, "S")] + cigar_items + [(softclip, "S")]
        strand = i % 2  # balanced strands (stable under strand-bias filters)
        qname = f"sim{i:05d}"
        truth.hap_of_read[qname] = hap
        tags = bamio.make_tag_bytes("de", "f", 0.001)
        if ts_tags:
            tags += bamio.make_tag_bytes("ts", "A", "+" if strand == 0 else "-")
        reads.append((pos, qname, 16 if strand else 0,
                      bamio.encode_cigar(cigar_items), bytes(hseq), quals, tags))
    reads.sort(key=lambda t: t[0])
    with bamio.BamWriter(path, [contig], [L]) as w:
        for pos, qname, flag, cigar, seq, quals, tags in reads:
            w.write_record(qname=qname, flag=flag, ref_id=0, pos=pos, mapq=60,
                           cigar=cigar, seq=seq, qual=quals, tags=tags)
    write_fasta(path.replace(".bam", ".fa"), {contig: bytes(ref)})
