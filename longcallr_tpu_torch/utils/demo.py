"""Demo workload support.

The reference repo's demo (`demo/demo.bam` vs `demo/chr20.fa`, preset
hifi-masseq — README.md:142-145) cannot run verbatim here because
`demo/chr20.fa` is a stripped large blob (.MISSING_LARGE_BLOBS); only its
.fai is vendored. This module derives a *consensus pseudo-reference* over
the covered windows (majority pileup base, N elsewhere) so the full pipeline
can run on the real reads as an integration/benchmark workload. Calls are
made against the consensus, so absolute variant positions differ from runs
against GRCh38, but depth, read length, error profile and all kernel work
are the real thing.

Copied from ``longcallr_tpu/utils/demo.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
One change: the demo BAM's location is read from ``LONGCALLR_DEMO_BAM``
(empty when unset).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import preset
from ..io.bam import BamFile
from ..io.fasta import FastaFile, write_fasta
from ..tiles.pileup import build_pileup
from ..tiles.regions import extract_isolated_regions_parallel

# where the reference repo's demo/demo.bam lies on this host
DEMO_BAM = os.environ.get("LONGCALLR_DEMO_BAM", "")
CHR20_LEN = 64_444_167

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_consensus_reference(bam_path: str, out_fasta: str,
                             contig: str = "chr20",
                             contig_len: int = CHR20_LEN,
                             threads: int = 4) -> str:
    """Build the consensus FASTA (cached: returns immediately if present)."""
    if os.path.exists(out_fasta) and os.path.exists(out_fasta + ".fai"):
        return out_fasta
    cfg = preset("hifi-masseq").replace(threads=threads)
    bam = BamFile(bam_path, threads=threads)
    regions = extract_isolated_regions_parallel(bam, [(contig, contig_len)], cfg)
    ref = np.full(contig_len, ord("N"), dtype=np.uint8)
    for reg in regions:
        pl = build_pileup(bam, reg, ref, cfg)
        cons = _ACGT[np.argmax(pl.cnt, axis=1)]
        cons[pl.cnt.sum(axis=1) == 0] = ord("N")
        ref[reg.start - 1: reg.end - 1] = cons
    os.makedirs(os.path.dirname(out_fasta) or ".", exist_ok=True)
    write_fasta(out_fasta, {contig: bytes(ref)})
    return out_fasta


def make_scaled_demo(bam_path: str, out_bam: str, out_fasta: str,
                     copies: int, spacing: int = 2_000_000,
                     contig: str = "chr20", contig_len: int = CHR20_LEN,
                     threads: int = 4) -> None:
    """Replicate the demo locus ``copies`` times at ``spacing`` offsets: a
    multi-region benchmark workload with real read content (cached)."""
    if os.path.exists(out_bam) and os.path.exists(out_fasta + ".fai"):
        return
    from ..io.bam import BamWriter
    consensus = make_consensus_reference(bam_path, out_fasta + ".base.fa",
                                         contig, contig_len, threads)
    base = FastaFile(consensus).fetch(contig)
    bam = BamFile(bam_path, threads=threads)
    ref = np.full(contig_len, ord("N"), dtype=np.uint8)
    lo = int(bam.pos.min())
    hi = max(int(bam.read(i).reference_end()) for i in range(bam.n_records))
    window = base[lo:hi]
    with BamWriter(out_bam, bam.references, bam.lengths,
                   header_text=bam.header_text, threads=threads) as w:
        for c in range(copies):
            off = c * spacing
            if hi + off > contig_len:
                break
            ref[lo + off: hi + off] = window
            for i in range(bam.n_records):
                r = bam.read(i)
                w.write_record(qname=f"{r.qname}_c{c}", flag=r.flag,
                               ref_id=r.ref_id, pos=r.pos + off, mapq=r.mapq,
                               cigar=r.cigar, seq=bytes(r.seq), qual=r.qual,
                               tags=r.aux_bytes())
    write_fasta(out_fasta, {contig: bytes(ref)})
