"""Generator ``genome``: contigs of isolated diploid loci, each locus a
(length, coverage, SNP spacing), with reads of one length drawn from both
haplotypes, written as an indexed BAM and a FASTA.

Frozen copy of ``make_genome_workload`` in
``longcallr_tpu_torch/utils/bench_workload.py`` at commit
fbeccaa9682300b9b3ab6ff3e33e50e6f6928b91, with three changes: the seed is
the run's, the files are written by ``harness/bamio.py``, and nothing is
cached. For one seed the draws, and so the reads, are those of the
original.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from harness import bamio

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# alternative alleles that avoid the A>G and T>C editing transitions, so
# that every planted site stays a plain heterozygous SNP
_ALTS = {ord("A"): b"CT", ord("C"): b"AGT", ord("G"): b"ACT", ord("T"): b"AG"}


def generate(bam_path: str, fasta_path: str, seed: int, contigs, gap: int = 40_000,
             err_rate: float = 0.002, read_len: int = 3_000,
             qual=(25, 31), alt_strands: bool = False) -> Dict:
    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    margin = 2_000
    refs: Dict[str, bytes] = {}
    names, lens, reads = [], [], []
    n_snps = 0
    for tid, (name, loci) in enumerate(contigs):
        L = margin + sum(rl + gap for rl, _, _ in loci)
        ref = _BASES[rng.integers(0, 4, size=L)]
        hap1 = ref.copy()
        spans = []
        cur = margin
        for rl, cov, spacing in loci:
            rstart, rend = cur, cur + rl
            spans.append((rstart, rend, cov))
            pos = rstart + 200
            while pos < rend - 200:
                p = int(pos + rng.integers(0, max(1, spacing // 4)))
                alts = _ALTS[int(ref[p])]
                hap1[p] = alts[int(rng.integers(0, len(alts)))]
                n_snps += 1
                pos += spacing
            cur = rend + gap
        haps = {1: hap1, 2: ref}
        cnt = 0
        for rstart, rend, cov in spans:
            n = int(np.ceil((rend - rstart) * cov / read_len))
            starts = rng.integers(rstart, rend - read_len, size=n)
            starts.sort()
            for i in range(n):
                hap = 1 + (i % 2)
                pos = int(starts[i])
                seq = haps[hap][pos:pos + read_len].copy()
                errs = rng.random(read_len) < err_rate
                ne = int(errs.sum())
                if ne:
                    seq[errs] = _BASES[rng.integers(0, 4, size=ne)]
                quals = rng.integers(qual[0], qual[1],
                                     size=read_len).astype(np.uint8)
                # the strand is drawn apart from the haplotype, so a true
                # heterozygous site keeps both strands
                flag = (16 if int(rng.integers(0, 2)) else 0) \
                    if alt_strands else 0
                reads.append((tid, pos, f"g{tid}_{cnt:06d}", flag, seq, quals))
                cnt += 1
        refs[name] = bytes(ref)
        names.append(name)
        lens.append(L)

    reads.sort(key=lambda t: (t[0], t[1]))
    w = bamio.BamWriter(bam_path, names, lens)
    de = bamio.tag_bytes("de", "f", err_rate)
    for tid, pos, qn, flag, seq, quals in reads:
        w.write(tid, pos, qn, flag, seq, quals, de)
    w.close(index=True)
    bamio.write_fasta(fasta_path, refs)
    return {"n_reads": len(reads), "n_snps": n_snps}
