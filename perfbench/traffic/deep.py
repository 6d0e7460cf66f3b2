"""Generator ``deep``: isolated deep, SNP-dense diploid loci on one contig,
reads alternating between the haplotypes, written as an indexed BAM and a
FASTA.

Frozen copy of ``make_deep_workload`` in
``longcallr_tpu_torch/utils/bench_workload.py`` at commit
fbeccaa9682300b9b3ab6ff3e33e50e6f6928b91, with three changes: the seed is
the run's, the files are written by ``harness/bamio.py`` (with a BAI), and
nothing is cached. For one seed the draws, and so the reads, are those of
the original.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from harness import bamio

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_ALTS = {ord("A"): b"CT", ord("C"): b"AGT", ord("G"): b"ACT", ord("T"): b"AG"}


def generate(bam_path: str, fasta_path: str, seed: int, n_regions: int = 4,
             region_len: int = 80_000, snp_spacing: int = 160,
             coverage: int = 150, read_len: int = 3_000,
             err_rate: float = 0.002, gap: int = 50_000,
             contig: str = "chrD") -> Dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    margin = 2_000
    L = margin + n_regions * (region_len + gap)
    ref = _BASES[rng.integers(0, 4, size=L)]
    hap1 = ref.copy()
    spans = []
    n_snps = 0
    for r in range(n_regions):
        rstart = margin + r * (region_len + gap)
        rend = rstart + region_len
        spans.append((rstart, rend))
        pos = rstart + 200
        while pos < rend - 200:
            p = int(pos + rng.integers(0, snp_spacing // 4))
            alts = _ALTS[int(ref[p])]
            hap1[p] = alts[int(rng.integers(0, len(alts)))]
            n_snps += 1
            pos += snp_spacing
    haps = {1: hap1, 2: ref}
    reads = []
    per_region = int(np.ceil(region_len * coverage / read_len))
    for r, (rstart, rend) in enumerate(spans):
        starts = rng.integers(rstart, rend - read_len, size=per_region)
        starts.sort()
        for i in range(per_region):
            hap = 1 + (i % 2)
            pos = int(starts[i])
            seq = haps[hap][pos:pos + read_len].copy()
            errs = rng.random(read_len) < err_rate
            ne = int(errs.sum())
            if ne:
                seq[errs] = _BASES[rng.integers(0, 4, size=ne)]
            qual = rng.integers(25, 31, size=read_len).astype(np.uint8)
            reads.append((pos, f"d{r:02d}_{i:05d}", seq, qual))
    reads.sort(key=lambda t: t[0])

    w = bamio.BamWriter(bam_path, [contig], [L])
    de = bamio.tag_bytes("de", "f", err_rate)
    for pos, qn, seq, qual in reads:
        w.write(0, pos, qn, 0, seq, qual, de)
    w.close(index=True)
    bamio.write_fasta(fasta_path, {contig: bytes(ref)})
    return {"n_reads": len(reads), "n_snps": n_snps}
