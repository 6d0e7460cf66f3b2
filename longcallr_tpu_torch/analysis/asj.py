"""Allele-specific junction (ASJ) analysis over a phased BAM.

Port of ``longcallR/allele_specific/longcallR-asj.py`` (C22) onto this
framework's I/O stack:
  * per-read exon/intron extraction from CIGAR (M/D runs merged, N =
    junction) with GT-AG / CT-AC canonical check against the reference
    (longcallR-asj.py:121-164);
  * min_junctions read filter and splice-aware read→gene assignment
    (:198-273);
  * junction clustering by shared donor/acceptor sites, optionally with
    internal exons (:339-440) — connected components via union-find
    (deterministic order; the reference's networkx set iteration is not);
  * per junction: absent/present read sets (:443-468), dominant phase set,
    2×2 Fisher exact + pseudocount G-test (max p) and the ASJ SOR
    log(R + 1/R) (:556-637);
  * BH FDR; outputs .asj.tsv, .asj_gene.tsv, .gene_coverage.tsv (:841-1049);
  * DNA-VCF filtering mode (:946-1049).

Copied from ``longcallr_tpu/analysis/asj.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

import argparse
import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
from scipy.stats import chi2, fisher_exact

from ..io.bam import BamFile
from ..io.fasta import FastaFile
from ..utils.intervals import IntervalIndex
from ..utils.stats import fdr_bh
from .ase import (DEFAULT_GENE_TYPES, get_gene_regions, load_dna_vcf,
                  load_longcallr_phased_vcf, merge_gene_exon_regions,
                  splice_match_segments)


def get_exon_intron_regions(read, ref_seq: np.ndarray, no_gtag: bool):
    """Per-read exon/intron regions, 1-based inclusive; introns tagged with
    the canonical-splice-signal check (longcallR-asj.py:121-164)."""
    exons: List[Tuple[int, int]] = []
    introns: List[Tuple[int, int, bool]] = []
    cur = read.pos + 1  # 1-based
    for w in read.cigar:
        op = int(w) & 0xF
        ln = int(w) >> 4
        if op in (0, 7, 8) or op == 2:  # M,=,X,D all consume reference "exon"
            if exons and exons[-1][1] + 1 == cur:
                exons[-1] = (exons[-1][0], exons[-1][1] + ln)
            else:
                exons.append((cur, cur + ln - 1))
            cur += ln
        elif op == 3:  # N: intron
            i_start, i_end = cur, cur + ln - 1
            if no_gtag:
                introns.append((i_start, i_end, False))
            else:
                left = bytes(ref_seq[i_start - 1: i_start + 1]).upper()
                right = bytes(ref_seq[i_end - 2: i_end]).upper()
                canonical = (left == b"GT" and right == b"AG") or \
                            (left == b"CT" and right == b"AC")
                introns.append((i_start, i_end, canonical))
            cur += ln
    return exons, introns


def load_reads(bam: BamFile, fasta: FastaFile, merged_genes_exons,
               no_gtag: bool, min_junctions: int = 0, threads: int = 1):
    """read→gene assignment + per-read positions/tags/exons/junctions
    (longcallR-asj.py:198-329). Reads with <= min_junctions junctions are
    dropped entirely. ``threads > 1`` chunk-parallelises the per-read walk
    over a fork-based process pool (the reference's load_reads process
    boundary, :276-329), COW-sharing the in-memory BAM + reference."""
    if threads > 1:
        from .ase import _fork_pool_ok
        if _fork_pool_ok():
            return _load_reads_pooled(bam, fasta, merged_genes_exons,
                                      no_gtag, min_junctions, threads)
    return _load_reads_range(bam, fasta, merged_genes_exons, no_gtag,
                             min_junctions, None)[:5]


def _load_reads_pooled(bam, fasta, merged_genes_exons, no_gtag,
                       min_junctions, threads):
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from .ase import ASE_CHUNK_MIN, _POOL
    chunks = []
    for chrom in merged_genes_exons:
        if chrom not in bam.references or chrom not in fasta:
            continue
        fasta.fetch(chrom)          # resident before the fork
        lo, hi = bam.contig_record_range(chrom)
        if hi <= lo:
            continue
        n_chunks = max(1, min(threads * 2, (hi - lo) // ASE_CHUNK_MIN))
        bounds = np.linspace(lo, hi, n_chunks + 1).astype(int)
        chunks += [(chrom, int(bounds[j]), int(bounds[j + 1]))
                   for j in range(n_chunks)]
    if len(chunks) <= 1:
        return _load_reads_range(bam, fasta, merged_genes_exons, no_gtag,
                                 min_junctions, None)[:5]
    # pre-build per-chrom interval indexes once in the parent (COW-shared)
    indexes = {chrom: _chrom_asj_indexes(genes)
               for chrom, genes in merged_genes_exons.items()
               if chrom in bam.references and chrom in fasta}
    _POOL["asj"] = (bam, fasta, merged_genes_exons, no_gtag, min_junctions,
                    indexes)
    try:
        outs = [{}, {}, {}, {}, {}]
        with ProcessPoolExecutor(max_workers=threads,
                                 mp_context=mp.get_context("fork")) as ex:
            for part in ex.map(_load_chunk, chunks):
                *dicts, deleted = part
                for acc, d in zip(outs, dicts):
                    acc.update(d)   # chunk order == read order
                # a later record of a duplicate qname that fails the
                # min_junctions filter deletes positions/tags entries set by
                # EARLIER records too (serial semantics) — apply the chunk's
                # net deletions across everything merged so far
                for q in deleted:
                    outs[1].pop(q, None)
                    outs[2].pop(q, None)
        return tuple(outs)
    finally:
        _POOL.pop("asj", None)


def _load_chunk(args):
    from .ase import _POOL
    bam, fasta, merged, no_gtag, min_junctions, indexes = _POOL["asj"]
    return _load_reads_range(bam, fasta, merged, no_gtag, min_junctions,
                             args, indexes)


def _chrom_asj_indexes(genes):
    gene_ivs, gene_ids = [], []
    exon_idx: Dict[str, IntervalIndex] = {}
    for gene_id, merged in genes.items():
        gene_ivs.append((merged[0][0], merged[-1][1] + 1))
        gene_ids.append(gene_id)
        exon_idx[gene_id] = IntervalIndex([(s, e + 1) for s, e in merged])
    return IntervalIndex(gene_ivs, gene_ids), exon_idx


def _load_reads_range(bam: BamFile, fasta: FastaFile, merged_genes_exons,
                      no_gtag: bool, min_junctions: int,
                      only: Optional[Tuple[str, int, int]],
                      indexes: Optional[dict] = None):
    read_assignment: Dict[str, str] = {}
    reads_positions: Dict[str, Tuple[int, int]] = {}
    reads_tags: Dict[str, dict] = {}
    reads_exons: Dict[str, list] = {}
    reads_junctions: Dict[str, list] = {}
    # qnames whose LAST record in this range failed the junction filter
    # (their positions/tags deletion must win over earlier chunks)
    deleted: Set[str] = set()
    for chrom, genes in merged_genes_exons.items():
        if only is not None and chrom != only[0]:
            continue
        if chrom not in bam.references or chrom not in fasta:
            continue
        ref_seq = fasta.fetch(chrom)
        if indexes is not None:
            tree, exon_idx = indexes[chrom]
        else:
            tree, exon_idx = _chrom_asj_indexes(genes)
        lo, hi = bam.contig_record_range(chrom)
        if only is not None:
            lo, hi = only[1], only[2]
        for ridx in range(lo, hi):
            r = bam.read(ridx)
            if r.is_unmapped:
                continue
            qname = r.qname
            hp = r.get_tag("HP")
            ps = r.get_tag("PS")
            reads_tags[qname] = {"PS": ps if ps is not None else ".",
                                 "HP": hp if hp is not None else "."}
            ref_end = r.reference_end()
            reads_positions[qname] = (r.pos + 1, ref_end)
            deleted.discard(qname)
            exons, introns = get_exon_intron_regions(r, ref_seq, no_gtag)
            if len(introns) <= min_junctions:
                del reads_positions[qname]
                del reads_tags[qname]
                deleted.add(qname)
                continue
            reads_exons[qname] = exons
            reads_junctions[qname] = introns
            cand = tree.overlap_data(r.pos + 1, ref_end + 1)
            if not cand:
                continue
            segs = splice_match_segments(r)
            best_gene, best_len = None, -1
            # quirk-faithful segment-exon overlap (see ase._assign_range)
            for gene_id in cand:
                total = sum(exon_idx[gene_id].overlap_length_ref(a, b)
                            for a, b in segs)
                if total > best_len:
                    best_gene, best_len = gene_id, total
            if best_gene is not None:
                read_assignment[qname] = best_gene
    return (read_assignment, reads_positions, reads_tags,
            reads_exons, reads_junctions, deleted)


class _UnionFind:
    def __init__(self):
        self.parent: Dict[object, object] = {}

    def add(self, x):
        self.parent.setdefault(x, x)

    def find(self, x):
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def cluster_junctions(reads_junctions: Dict[str, list],
                      reads_exons: Optional[Dict[str, list]],
                      min_count: int = 10):
    """Junction clusters via shared donor/acceptor connectivity; when
    reads_exons is given, internal exons join the graph (:339-440)."""
    junctions: Dict[Tuple[int, int], int] = {}
    gt_ag: Dict[Tuple[int, int], bool] = {}
    for _, juncs in reads_junctions.items():
        for (s, e, tag) in juncs:
            junctions[(s, e)] = junctions.get((s, e), 0) + 1
            gt_ag[(s, e)] = tag
    junctions = {k: v for k, v in junctions.items() if v >= min_count}
    nodes = [(s, e, "junction") for (s, e) in junctions]
    if reads_exons is not None:
        exons: Dict[Tuple[int, int], int] = {}
        for _, exon_regions in reads_exons.items():
            if len(exon_regions) > 2:
                for i, ex in enumerate(exon_regions):
                    if i == 0 or i == len(exon_regions) - 1:
                        continue
                    exons[ex] = exons.get(ex, 0) + 1
        exons = {k: v for k, v in exons.items() if v >= min_count}
        nodes += [(s - 1, e + 1, "exon") for (s, e) in exons]
    uf = _UnionFind()
    for n in nodes:
        uf.add(n)
    # index by endpoint for O(n) edge discovery
    by_start: Dict[Tuple[int, str], List] = defaultdict(list)
    by_end: Dict[Tuple[int, str], List] = defaultdict(list)
    for n in nodes:
        by_start[(n[0], n[2])].append(n)
        by_end[(n[1], n[2])].append(n)
    for n in nodes:
        s, e, typ = n
        for m in by_start[(s, typ)] + by_end[(e, typ)]:
            uf.union(n, m)  # same type sharing donor or acceptor
        other = "exon" if typ == "junction" else "junction"
        for m in by_end[(s, other)] + by_start[(e, other)]:
            uf.union(n, m)  # junction-exon adjacency (start1==end2 / end1==start2)
    comps: Dict[object, List] = defaultdict(list)
    for n in nodes:
        comps[uf.find(n)].append(n)
    clusters = []
    for comp in comps.values():
        clu = [(s, e, gt_ag[(s, e)]) for (s, e, typ) in sorted(comp)
               if typ == "junction"]
        if clu:
            clusters.append(clu)
    # deterministic cluster order by smallest member junction (independent
    # of union-find root identity; the reference's networkx set iteration
    # is unordered — PARITY.md deviation #10)
    clusters.sort(key=lambda c: (c[0][0], c[0][1]))
    return clusters, junctions


def check_absent_present(start_pos, end_pos, reads_positions, reads_junctions):
    """:443-468 — overlap-based absent/present read partition."""
    absent, present = [], []
    for qname, (rs, re) in reads_positions.items():
        if rs > end_pos or re < start_pos:
            continue
        is_present = any(js == start_pos and je == end_pos
                         for (js, je, _) in reads_junctions[qname])
        (present if is_present else absent).append(qname)
    return absent, present


def calc_sor(h1_absent, h1_present, h2_absent, h2_present) -> float:
    """ASJ strand-odds-ratio variant: log(R + 1/R) (:556-561)."""
    R = ((h1_absent + 1) * (h2_present + 1)) / ((h1_present + 1) * (h2_absent + 1))
    return math.log(R + 1.0 / R)


def g_test_2x2_pseudo(table, pseudocount: float = 1e-10):
    """G-test with pseudocount on observed AND expected, df=1 (:564-589)."""
    t = np.asarray(table, dtype=np.float64)
    row = t.sum(axis=1)
    col = t.sum(axis=0)
    total = t.sum()
    expected = np.outer(row, col) / total
    observed = t + pseudocount
    expected = expected + pseudocount
    G = 2.0 * np.sum(observed * np.log(observed / expected))
    return G, float(1.0 - chi2.cdf(G, 1))


def haplotype_event_test(absent_reads, present_reads, reads_tags):
    """Dominant-PS 2×2 test: max(Fisher, G-test) + SOR (:592-637)."""
    hap_absent = defaultdict(lambda: {1: 0, 2: 0})
    hap_present = defaultdict(lambda: {1: 0, 2: 0})
    for q in absent_reads:
        hap_absent[reads_tags[q]["PS"]][reads_tags[q]["HP"]] += 1
    for q in present_reads:
        hap_present[reads_tags[q]["PS"]][reads_tags[q]["HP"]] += 1
    all_ps = set(hap_absent) | set(hap_present)
    if not all_ps:
        return None
    ps_cnt = {ps: hap_absent[ps][1] + hap_absent[ps][2]
              + hap_present[ps][1] + hap_present[ps][2] for ps in all_ps}
    # dominant PS; the reference breaks count ties by set-iteration order
    # (hash-randomized for "." keys) — ties go to the smallest PS id here
    # (PARITY.md deviation #10)
    from .ase import _ps_order
    best_cnt = max(ps_cnt.values())
    ps = min((p for p, c in ps_cnt.items() if c == best_cnt), key=_ps_order)
    table = np.array([[hap_absent[ps][1], hap_absent[ps][2]],
                      [hap_present[ps][1], hap_present[ps][2]]])
    _, p_fisher = fisher_exact(table)
    _, p_g = g_test_2x2_pseudo(table)
    pvalue = max(float(p_fisher), p_g)
    sor = calc_sor(hap_absent[ps][1], hap_present[ps][1],
                   hap_absent[ps][2], hap_present[ps][2])
    return (ps, hap_absent[ps][1], hap_present[ps][1],
            hap_absent[ps][2], hap_present[ps][2], pvalue, sor)


class AseEvent:
    """One allele-specific junction candidate (:526-553)."""

    def __init__(self, chrom, start, end, novel, gt_ag_tag, gene_name, strand,
                 junction_set, phase_set, h1_a, h1_p, h2_a, h2_p, p_value, sor):
        self.chr = chrom
        self.start = start
        self.end = end
        self.novel = novel
        self.gt_ag_tag = gt_ag_tag
        self.gene_name = gene_name
        self.strand = strand
        self.junction_set = junction_set
        self.phase_set = phase_set
        self.hap1_absent = h1_a
        self.hap1_present = h1_p
        self.hap2_absent = h2_a
        self.hap2_present = h2_p
        self.p_value = p_value
        self.sor = sor

    @staticmethod
    def header():
        return ("#Junction\tStrand\tJunction_set\tPhase_set\tHap1_absent\t"
                "Hap1_present\tHap2_absent\tHap2_present\tP_value\tSOR\t"
                "Novel\tGT_AG\tGene_name")

    def __str__(self):
        return (f"{self.chr}:{self.start}-{self.end}\t{self.strand}\t"
                f"{self.junction_set}\t{self.phase_set}\t{self.hap1_absent}\t"
                f"{self.hap1_present}\t{self.hap2_absent}\t{self.hap2_present}\t"
                f"{self.p_value}\t{self.sor}\t{self.novel}\t{self.gt_ag_tag}\t"
                f"{self.gene_name}")


def analyze_gene(gene_name, gene_strand, anno_exons, anno_introns, gene_region,
                 gene_reads, min_count, cluster_with_exons, reads_positions,
                 reads_tags, reads_exons, reads_introns,
                 dna_vcfs=None, rna_vcfs=None):
    """Per-gene junction events (:667-741; filtering variant :744-830)."""
    valid = set(gene_reads) & set(reads_tags)
    phased = [q for q in valid if reads_tags[q]["HP"] != "."]
    sub_pos = {q: reads_positions[q] for q in phased}
    sub_tags = {q: reads_tags[q] for q in phased}
    sub_exons = {q: reads_exons[q] for q in phased}
    sub_introns = {q: reads_introns[q] for q in phased}
    chrom = gene_region["chr"]
    gene_junc_set = {j for juncs in anno_introns.values() for j in juncs}
    gene_exon_set = {e for exons in anno_exons.values() for e in exons}
    clusters, _ = cluster_junctions(sub_introns,
                                    sub_exons if cluster_with_exons else None,
                                    min_count)
    exon_iv = IntervalIndex([(s, e + 1) for (_, s, e) in gene_exon_set])
    to_remove = set()
    if dna_vcfs is not None:
        # drop reads whose phase set has no DNA-supported variants (:781-790)
        for q in sub_tags:
            ps = sub_tags[q]["PS"]
            snps = rna_vcfs.get(ps, []) if rna_vcfs else []
            if not any(f"{s.split(':')[0]}:{s.split(':')[1]}" in dna_vcfs
                       for s in snps):
                to_remove.add(q)
    for q, exons in sub_exons.items():
        if not any(exon_iv.overlap(s, e + 1) for (s, e) in exons):
            to_remove.add(q)
    for q in to_remove:
        del sub_pos[q], sub_tags[q], sub_exons[q], sub_introns[q]

    events = []
    for clu in clusters:
        if not clu:
            continue
        junction_set = f"{chrom}:{clu[0][0]}-{clu[0][1]}"
        for (js, je, tag) in clu:
            novel = (chrom, js, je) not in gene_junc_set
            absent, present = check_absent_present(js, je, sub_pos, sub_introns)
            res = haplotype_event_test(absent, present, sub_tags)
            if res is None:
                continue
            (ps, h1a, h1p, h2a, h2p, pval, sor) = res
            events.append(AseEvent(chrom, js, je, novel, tag, gene_name,
                                   gene_strand, junction_set, ps,
                                   h1a, h1p, h2a, h2p, pval, sor))
    return events


def analyze(annotation_file, bam_file, reference_file, output_prefix,
            min_count=10, gene_types=DEFAULT_GENE_TYPES, threads=1,
            no_gtag=False, min_junctions=2, cluster_with_exons=False,
            dna_vcfs=None, rna_vcfs=None) -> None:
    """:841-1049 (and the filtering variant)."""
    (gene_regions, gene_names, gene_strands,
     exon_regions) = get_gene_regions(annotation_file, set(gene_types))
    # annotation introns per gene/transcript (ase parser drops them; rebuild)
    anno_introns: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
    for gid, transcripts in exon_regions.items():
        for tid, exons in transcripts.items():
            if len(exons) <= 1:
                continue
            es = sorted(exons, key=lambda x: x[1])
            for i in range(1, len(es)):
                s = es[i - 1][2] + 1
                e = es[i][1] - 1
                if s < e:
                    anno_introns[gid][tid].append((es[i - 1][0], s, e))
    merged = merge_gene_exon_regions(exon_regions)
    bam = BamFile(bam_file, threads=threads)
    fasta = FastaFile(reference_file)
    (read_assignment, reads_positions, reads_tags, reads_exons,
     reads_introns) = load_reads(bam, fasta, merged, no_gtag,
                                 min_junctions, threads)
    gene_assigned = defaultdict(list)
    for q, g in read_assignment.items():
        gene_assigned[g].append(q)

    with open(output_prefix + ".gene_coverage.tsv", "w") as f:
        f.write("#Gene_name\tChr\tStart\tEnd\tNum_reads\n")
        for gid, reg in gene_regions.items():
            cov = len(gene_assigned.get(gid, []))
            f.write(f"{gene_names[gid]}\t{reg['chr']}\t{reg['start']}\t"
                    f"{reg['end']}\t{cov}\n")

    all_events: Dict[Tuple, Dict[str, AseEvent]] = {}
    for gid, reg in gene_regions.items():
        if reg["chr"] not in fasta or not gene_assigned.get(gid):
            continue
        evs = analyze_gene(gene_names[gid], gene_strands[gid],
                           exon_regions[gid], anno_introns[gid], reg,
                           gene_assigned[gid], min_count, cluster_with_exons,
                           reads_positions, reads_tags, reads_exons,
                           reads_introns, dna_vcfs=dna_vcfs, rna_vcfs=rna_vcfs)
        for ev in evs:
            all_events.setdefault((ev.chr, ev.start, ev.end), {})[ev.gene_name] = ev

    juncs = [(k, g) for k in all_events for g in all_events[k]]
    pass_idx, p_values = [], []
    for idx, (k, g) in enumerate(juncs):
        ev = all_events[k][g]
        if (ev.hap1_absent + ev.hap1_present + ev.hap2_absent
                + ev.hap2_present >= min_count):
            pass_idx.append(idx)
            p_values.append(ev.p_value)
    _, adjusted = fdr_bh(p_values, alpha=0.05)
    asj_genes: Dict[str, list] = {}
    with open(output_prefix + ".asj.tsv", "w") as f:
        f.write(AseEvent.header() + "\n")
        for pi, idx in enumerate(pass_idx):
            k, g = juncs[idx]
            ev = all_events[k][g]
            ev.p_value = adjusted[pi]
            f.write(str(ev) + "\n")
            if not no_gtag and not ev.gt_ag_tag:
                continue
            if g not in asj_genes or ev.p_value < asj_genes[g][1]:
                asj_genes[g] = [ev.chr, ev.p_value, ev.sor]
    with open(output_prefix + ".asj_gene.tsv", "w") as f:
        f.write("#Gene_name\tChr\tP_value\tSOR\n")
        for g, (chrom, p, sor) in asj_genes.items():
            f.write(f"{g}\t{chrom}\t{p}\t{sor}\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="longcallr-tpu-asj")
    p.add_argument("-a", "--annotation_file", required=True)
    p.add_argument("-b", "--bam_file", required=True)
    p.add_argument("--dna_vcf")
    p.add_argument("--rna_vcf")
    p.add_argument("--min_junctions", type=int, default=2)
    p.add_argument("--cluster_with_exons", action="store_true")
    p.add_argument("-f", "--reference", required=True)
    p.add_argument("-o", "--output_prefix", required=True)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-g", "--gene_types", type=str, nargs="+",
                   default=list(DEFAULT_GENE_TYPES))
    p.add_argument("-m", "--min_sup", type=int, default=10)
    p.add_argument("--no_gtag", action="store_true")
    args = p.parse_args(argv)
    dna_vcfs = rna_vcfs = None
    if args.dna_vcf and args.rna_vcf:
        dna_vcfs = load_dna_vcf(args.dna_vcf)
        rna_vcfs = load_longcallr_phased_vcf(args.rna_vcf, with_dp_af=False)
    analyze(args.annotation_file, args.bam_file, args.reference,
            args.output_prefix, args.min_sup, set(args.gene_types),
            args.threads, args.no_gtag, args.min_junctions,
            args.cluster_with_exons, dna_vcfs=dna_vcfs, rna_vcfs=rna_vcfs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
