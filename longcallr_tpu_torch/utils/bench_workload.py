"""Deep phased benchmark workload.

The demo locus (1 region, K=1697 reads, I=19 candidates) never exercises
the device path: phase work scales as cells × rounds (rounds = I//4+1,
``longcallR/src/phase.rs:1198-1233``), and at I=19 the whole schedule is
milliseconds of host work. This generator synthesizes the workload class
the device path exists for — several deep, SNP-dense diploid loci:

  * per region ~``region_len/snp_spacing`` het SNPs (I ≈ 500 → 126
    perturbation rounds) at ~50/50 allele balance,
  * ``coverage``× read depth (K ≈ region_len·coverage/read_len reads),
  * phased haplotypes: hap1 carries ALT at every het site, reads alternate
    haplotypes, base errors at ``err_rate``.

The resulting per-region ascent problem (K≈4096 × I≈512 padded, ~126
rounds) is the deep main-path shape of the hand kernels.
Regions are separated by coverage gaps so
region discovery (tiles/regions.py) finds them independently.

A→G and T→C substitutions are avoided so no planted SNP trips the
RNA-editing classifier (``candidate.rs:309-344``) — every site stays a
plain phaseable het.

Workload files are cached on disk; a JSON sidecar records the parameters
and the generator version, and a mismatch regenerates.

Copied from ``longcallr_tpu/utils/bench_workload.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
One change: the source's timing remark, taken on other hardware, is
left out of this docstring.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from ..io import bam as bamio
from ..io.fasta import write_fasta

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# v2: sidecars carry the planted truth set (per-contig [pos0, ref, alt]
# triples; hap1 carries ALT at every site) for the bench's accuracy leg
_GEN_VERSION = 2

# alt choices per ref base avoiding the A→G / T→C editing transitions
_ALTS = {ord("A"): b"CT", ord("C"): b"AGT", ord("G"): b"ACT", ord("T"): b"AG"}


def make_deep_workload(out_bam: str, out_fasta: str, n_regions: int = 4,
                       region_len: int = 80_000, snp_spacing: int = 160,
                       coverage: int = 150, read_len: int = 3_000,
                       err_rate: float = 0.002, gap: int = 50_000,
                       seed: int = 20_260_817, contig: str = "chrD") -> Dict:
    """Generate (or reuse from cache) the deep workload. Returns the params
    dict (incl. derived totals)."""
    params = dict(version=_GEN_VERSION, n_regions=n_regions,
                  region_len=region_len, snp_spacing=snp_spacing,
                  coverage=coverage, read_len=read_len, err_rate=err_rate,
                  gap=gap, seed=seed, contig=contig)
    side = out_bam + ".params.json"
    if (os.path.exists(out_bam) and os.path.exists(out_fasta + ".fai")
            and os.path.exists(side)):
        try:
            with open(side) as f:
                old = json.load(f)
            if {k: old.get(k) for k in params} == params:
                return old
        except (OSError, ValueError):
            pass

    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    margin = 2_000
    L = margin + n_regions * (region_len + gap)
    ref = _BASES[rng.integers(0, 4, size=L)]

    # plant het SNPs; hap1 carries ALT everywhere (fixed phase convention)
    hap1 = ref.copy()
    region_spans = []
    truth = []      # [pos0, ref_base, alt_base] per planted site
    for r in range(n_regions):
        rstart = margin + r * (region_len + gap)
        rend = rstart + region_len
        region_spans.append((rstart, rend))
        pos = rstart + 200
        while pos < rend - 200:
            p = int(pos + rng.integers(0, snp_spacing // 4))
            alts = _ALTS[int(ref[p])]
            hap1[p] = alts[int(rng.integers(0, len(alts)))]
            truth.append([p, chr(ref[p]), chr(hap1[p])])
            pos += snp_spacing
    n_snps = len(truth)
    haps = {1: hap1, 2: ref}

    reads = []
    per_region = int(np.ceil(region_len * coverage / read_len))
    for r, (rstart, rend) in enumerate(region_spans):
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

    tmp_bam = out_bam + ".tmp"
    with bamio.BamWriter(tmp_bam, [contig], [L]) as w:
        for pos, qn, seq, qual in reads:
            w.write_record(qname=qn, flag=0, ref_id=0, pos=pos, mapq=60,
                           cigar=bamio.encode_cigar([(len(seq), "M")]),
                           seq=bytes(seq), qual=qual,
                           tags=bamio.make_tag_bytes("de", "f", err_rate))
    os.replace(tmp_bam, out_bam)
    write_fasta(out_fasta, {contig: bytes(ref)})

    params.update(n_reads=len(reads), n_snps=n_snps, contig_len=L,
                  truth={contig: truth})
    with open(side, "w") as f:
        json.dump(params, f)
    return params


def make_genome_workload(out_bam: str, out_fasta: str,
                         contigs=None, gap: int = 40_000,
                         seed: int = 20_260_818,
                         err_rate: float = 0.002, read_len: int = 3_000,
                         qual: Tuple[int, int] = (25, 31),
                         alt_strands: bool = False) -> Dict:
    """Multi-contig whole-genome-style workload for ``--stream`` validation:
    several contigs with mixed region sizes (including a deep "giant"
    locus), BAI-indexed, cached like make_deep_workload.

    ``contigs``: list of (name, [(region_len, coverage, snp_spacing), ...]).
    Default: 3 contigs, 8 loci, one giant (deep) locus on the middle contig.

    ``err_rate``/``read_len``/``qual``/``alt_strands`` shape the error
    model (the ONT accuracy leg uses ~6% error, lower quals, and balanced
    strand flags so the ont presets' strand-bias/end-trim machinery is
    live). With the defaults the generated bytes are identical to the
    pre-parameter version (no extra RNG draws on the default path).
    """
    from ..io.bai import build_bai

    if contigs is None:
        contigs = [
            ("chrA", [(30_000, 40, 160), (20_000, 60, 200)]),
            ("chrB", [(30_000, 300, 200), (10_000, 50, 150)]),   # giant locus
            ("chrC", [(15_000, 40, 160), (15_000, 40, 300), (8_000, 80, 150)]),
        ]
    spec = [(n, list(map(list, rs))) for n, rs in contigs]
    params = dict(version=_GEN_VERSION, kind="genome", contigs=spec,
                  gap=gap, seed=seed, err_rate=err_rate, read_len=read_len,
                  qual=list(qual), alt_strands=alt_strands)
    side = out_bam + ".params.json"
    if (os.path.exists(out_bam) and os.path.exists(out_fasta + ".fai")
            and os.path.exists(out_bam + ".bai") and os.path.exists(side)):
        try:
            with open(side) as f:
                old = json.load(f)
            if {k: old.get(k) for k in params} == params:
                return old
        except (OSError, ValueError):
            pass

    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    margin = 2_000
    refs: Dict[str, bytes] = {}
    per_contig_reads = {}
    n_snps = 0
    names, lens = [], []
    all_reads = []   # (tid, pos, qname, seq, qual)
    truth: Dict[str, list] = {}
    for tid, (name, loci) in enumerate(contigs):
        L = margin + sum(rl + gap for rl, _, _ in loci)
        ref = _BASES[rng.integers(0, 4, size=L)]
        hap1 = ref.copy()
        spans = []
        cur = margin
        ctruth = []
        for rl, cov, spacing in loci:
            rstart, rend = cur, cur + rl
            spans.append((rstart, rend, cov))
            pos = rstart + 200
            while pos < rend - 200:
                p = int(pos + rng.integers(0, max(1, spacing // 4)))
                alts = _ALTS[int(ref[p])]
                hap1[p] = alts[int(rng.integers(0, len(alts)))]
                ctruth.append([p, chr(ref[p]), chr(hap1[p])])
                pos += spacing
            cur = rend + gap
        truth[name] = ctruth
        n_snps += len(ctruth)
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
                # strand decorrelated from haplotype (hap follows i%2), so
                # true het ALT support stays strand-balanced and only
                # artifacts look biased — the SOR filter's design premise
                flag = (16 if int(rng.integers(0, 2)) else 0) \
                    if alt_strands else 0
                all_reads.append((tid, pos, f"g{tid}_{cnt:06d}", flag,
                                  seq, quals))
                cnt += 1
        per_contig_reads[name] = cnt
        refs[name] = bytes(ref)
        names.append(name)
        lens.append(L)

    all_reads.sort(key=lambda t: (t[0], t[1]))
    tmp_bam = out_bam + ".tmp"
    with bamio.BamWriter(tmp_bam, names, lens) as w:
        for tid, pos, qn, flag, seq, quals in all_reads:
            w.write_record(qname=qn, flag=flag, ref_id=tid, pos=pos, mapq=60,
                           cigar=bamio.encode_cigar([(len(seq), "M")]),
                           seq=bytes(seq), qual=quals,
                           tags=bamio.make_tag_bytes("de", "f", err_rate))
    os.replace(tmp_bam, out_bam)
    write_fasta(out_fasta, refs)
    build_bai(out_bam)

    params.update(n_reads=len(all_reads), n_snps=n_snps,
                  per_contig_reads=per_contig_reads, truth=truth)
    with open(side, "w") as f:
        json.dump(params, f)
    return params
