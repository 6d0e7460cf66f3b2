"""Allele-specific expression (ASE) analysis over a phased BAM.

Port of ``longcallR/allele_specific/longcallR-ase.py`` (C21) onto this
framework's own I/O stack (no pysam / intervaltree / statsmodels):
  * GTF/GFF3 gene+exon parsing with gene_type filter and readthrough
    exclusion (longcallR-ase.py:64-163);
  * transcript-exon merging into per-gene collapsed exons (:166-194);
  * splice-aware read→gene assignment by best exon-overlap of the read's
    CIGAR match segments (:197-349) — vectorised over the in-memory BAM;
  * per-gene dominant phase set, H1/H2 counts, two-sided beta-binomial test
    (μ=0.5, overdispersion ρ, :454-478) with BH FDR (:614-630);
  * --vcf1+--vcf2 paternal/maternal resolution via a phased DNA VCF
    (:481-553) and --vcf1+--vcf3 DNA-supported filtering (:556-597).

Copied from ``longcallr_tpu/analysis/ase.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged but for ``_fork_pool_ok``, which refuses to fork
once CUDA is initialised (the original looks for live JAX backends).
"""

from __future__ import annotations

import argparse
import gzip
import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..io.bam import BamFile, aligned_bases_at
from ..utils.intervals import IntervalIndex, merge_intervals
from ..utils.stats import beta_binomial_two_sided, fdr_bh

DEFAULT_GENE_TYPES = ("protein_coding", "lncRNA")


# ---------------------------------------------------------------------------
# annotation
# ---------------------------------------------------------------------------

def _parse_attrs_gff3(attributes: str) -> Dict[str, str]:
    d: Dict[str, str] = {}
    for attr in attributes.strip().split(";"):
        if "=" in attr:
            k, v = attr.strip().split("=", 1)
            d[k] = v.replace('"', "")
    return d


def _parse_attrs_gtf(attributes: str) -> Dict[str, str]:
    d: Dict[str, str] = {}
    tags: List[str] = []
    for attr in attributes.strip().split(";"):
        attr = attr.strip()
        if not attr:
            continue
        if " " in attr:
            k, v = attr.split(" ", 1)
            v = v.replace('"', "")
            if k == "tag":
                tags.append(v)
            else:
                d[k] = v
    d["tag"] = ",".join(tags)
    return d


def get_gene_regions(annotation_file: str, gene_types: Set[str]):
    """(gene_regions, gene_names, gene_strands, exon_regions) —
    longcallR-ase.py:64-163 (introns are derivable but unused)."""
    gene_regions: Dict[str, dict] = {}
    gene_names: Dict[str, str] = {}
    gene_strands: Dict[str, str] = {}
    exon_regions: Dict[str, Dict[str, List[Tuple[str, int, int]]]] = \
        defaultdict(lambda: defaultdict(list))
    is_gff3 = ".gff3" in annotation_file
    opener = gzip.open if annotation_file.endswith(".gz") else open
    with opener(annotation_file, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                continue
            feature = parts[2]
            if feature not in ("gene", "exon"):
                continue
            attrs = (_parse_attrs_gff3 if is_gff3 else _parse_attrs_gtf)(parts[8])
            gtype = attrs.get("gene_type", attrs.get("gene_biotype", ""))
            if gtype not in gene_types or "readthrough" in attrs.get("tag", ""):
                continue
            gene_id = attrs.get("gene_id", "")
            if feature == "gene":
                gene_regions[gene_id] = {"chr": parts[0], "start": int(parts[3]),
                                         "end": int(parts[4])}
                gene_names[gene_id] = attrs.get("gene_name", ".")
                gene_strands[gene_id] = parts[6]
            else:
                tid = attrs.get("transcript_id", "")
                exon_regions[gene_id][tid].append(
                    (parts[0], int(parts[3]), int(parts[4])))
    return gene_regions, gene_names, gene_strands, exon_regions


def merge_gene_exon_regions(exon_regions) -> Dict[str, Dict[str, List[Tuple[int, int]]]]:
    """chr → gene_id → merged 1-based closed exon list (:166-194)."""
    out: Dict[str, Dict[str, List[Tuple[int, int]]]] = defaultdict(dict)
    for gene_id, transcripts in exon_regions.items():
        chr_set = {chrom for exons in transcripts.values() for (chrom, _, _) in exons}
        if len(chr_set) != 1:
            continue
        chrom = chr_set.pop()
        ivs = [(s, e + 1) for exons in transcripts.values()
               for (_, s, e) in exons]
        merged = [(s, e - 1) for (s, e) in merge_intervals(ivs)]
        out[chrom][gene_id] = merged
    return out


# ---------------------------------------------------------------------------
# read → gene assignment
# ---------------------------------------------------------------------------

def splice_match_segments(read) -> List[Tuple[int, int]]:
    """1-based closed match segments (M/D/=/X runs split at N), as
    longcallR-ase.py:228-241."""
    segs: List[Tuple[int, int]] = []
    cur = read.pos + 1
    shift = 0
    for w in read.cigar:
        op = int(w) & 0xF
        ln = int(w) >> 4
        if op in (0, 2, 7, 8):   # M,D,=,X
            shift += ln
        elif op == 3:            # N
            if shift > 0:
                segs.append((cur, cur + shift - 1))
            cur += shift + ln
            shift = 0
    if shift > 0:
        segs.append((cur, cur + shift - 1))
    return segs


def _chrom_indexes(genes):
    gene_ivs = []
    gene_ids = []
    exon_idx: Dict[str, IntervalIndex] = {}
    for gene_id, merged in genes.items():
        gene_ivs.append((merged[0][0], merged[-1][1] + 1))
        gene_ids.append(gene_id)
        exon_idx[gene_id] = IntervalIndex([(s, e + 1) for s, e in merged])
    return IntervalIndex(gene_ivs, gene_ids), exon_idx


def _assign_range(bam: BamFile, tree: IntervalIndex,
                  exon_idx: Dict[str, IntervalIndex],
                  lo: int, hi: int) -> Dict[str, str]:
    assignment: Dict[str, str] = {}
    for ridx in range(lo, hi):
        r = bam.read(ridx)
        if r.is_unmapped:
            continue
        s1, e1 = r.pos + 1, r.reference_end() + 1  # 1-based half-open query
        cand = tree.overlap_data(s1, e1)
        if not cand:
            continue
        segs = splice_match_segments(r)
        best_gene, best_len = None, -1
        # overlap_length_ref replicates the reference's half-open candidate
        # query over the closed segment (longcallR-ase.py:249-253: an exon
        # starting exactly at a segment's last base counts 0). Ties go to
        # the first gene in merged-exon start order (PARITY.md #10; the
        # reference's max() over intervaltree set order is unordered).
        for gene_id in cand:
            total = sum(exon_idx[gene_id].overlap_length_ref(a, b)
                        for a, b in segs)
            if total > best_len:
                best_gene, best_len = gene_id, total
        if best_gene is not None and best_len >= 0:
            assignment[r.qname] = best_gene
    return assignment


# fork-shared state for the process pool: the in-memory BAM and per-chrom
# interval indexes are inherited copy-on-write by the workers (the same
# globals trick as longcallR-asj.py:833-839; longcallR-ase.py:308 uses a
# chunked ProcessPoolExecutor the same way)
_POOL = {}

# minimum reads per pool chunk (fork+IPC overhead floor)
ASE_CHUNK_MIN = 2048

# tri-state: None = auto (fork available and CUDA not initialised in this
# process — a forked child cannot use the parent's CUDA context, and the
# CUDA runtime's threads make fork() deadlock-prone), True/False forces
FORK_POOL: Optional[bool] = None


def _fork_pool_ok() -> bool:
    if FORK_POOL is not None:
        return FORK_POOL
    import sys
    t = sys.modules.get("torch")      # the tools never import torch for this
    if t is not None and t.cuda.is_initialized():
        return False                  # CUDA context live in this process
    import multiprocessing as mp
    return "fork" in mp.get_all_start_methods()


def _assign_chunk(args):
    chrom, lo, hi = args
    tree, exon_idx = _POOL["idx"][chrom]
    return _assign_range(_POOL["bam"], tree, exon_idx, lo, hi)


def assign_reads_to_gene(bam: BamFile, merged_genes_exons,
                         threads: int = 1) -> Dict[str, str]:
    """read_name → best gene_id (:197-258); chunk-parallel over a
    fork-based process pool when ``threads > 1`` (:308)."""
    per_chrom = {}
    chunks = []
    for chrom, genes in merged_genes_exons.items():
        if chrom not in bam.references:
            continue
        per_chrom[chrom] = _chrom_indexes(genes)
        lo, hi = bam.contig_record_range(chrom)
        if hi <= lo:
            continue
        n_chunks = max(1, min(threads * 2, (hi - lo) // ASE_CHUNK_MIN)) \
            if threads > 1 else 1
        bounds = np.linspace(lo, hi, n_chunks + 1).astype(int)
        chunks += [(chrom, int(bounds[j]), int(bounds[j + 1]))
                   for j in range(n_chunks)]

    assignment: Dict[str, str] = {}
    use_pool = threads > 1 and len(chunks) > 1 and _fork_pool_ok()
    if use_pool:
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        from concurrent.futures import ProcessPoolExecutor
        _POOL["bam"] = bam
        _POOL["idx"] = per_chrom
        try:
            with ProcessPoolExecutor(max_workers=threads,
                                     mp_context=ctx) as ex:
                for part in ex.map(_assign_chunk, chunks):
                    assignment.update(part)    # chunk order == read order
        finally:
            _POOL.clear()
        return assignment
    for chrom, lo, hi in chunks:
        tree, exon_idx = per_chrom[chrom]
        assignment.update(_assign_range(bam, tree, exon_idx, lo, hi))
    return assignment


def transform_read_assignment(read_assignment: Dict[str, str]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = defaultdict(list)
    for rname, gid in read_assignment.items():
        out[gid].append(rname)
    return out


# ---------------------------------------------------------------------------
# VCF loaders (text parsers; .gz supported)
# ---------------------------------------------------------------------------

def _iter_vcf_records(vcf_file: str):
    opener = gzip.open if vcf_file.endswith((".gz", ".bgz")) else open
    try:
        f = opener(vcf_file, "rt")
    except OSError:
        from ..io.bgzf import decompress_file
        import io as _io
        f = _io.StringIO(decompress_file(vcf_file).decode())
    with f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 10:
                continue
            fmt = parts[8].split(":")
            sample = dict(zip(fmt, parts[9].split(":")))
            yield parts, sample


def _gt_tuple(gt: str):
    sep = "|" if "|" in gt else "/"
    al = gt.replace("|", "/").split("/")
    try:
        return tuple(int(a) for a in al), "|" in gt
    except ValueError:
        return None, False


def load_whole_genome_phased_vcf(vcf_file: str) -> Dict[str, dict]:
    """chr:pos → {gt, pat, mat} for phased hets (:360-385)."""
    out: Dict[str, dict] = {}
    for parts, sample in _iter_vcf_records(vcf_file):
        ref, alts = parts[3], parts[4].split(",")
        if any(len(ref) != len(a) for a in alts):
            continue
        gt, phased = _gt_tuple(sample.get("GT", "."))
        if gt in ((0, 1), (1, 0)) and phased:
            key = f"{parts[0]}:{parts[1]}"
            if gt == (0, 1):
                out[key] = {"gt": gt, "pat": alts[0], "mat": ref}
            else:
                out[key] = {"gt": gt, "pat": ref, "mat": alts[0]}
    return out


def load_dna_vcf(vcf_file: str) -> Dict[str, dict]:
    """chr:pos → {gt, ref, alt} for het variants (:388-408)."""
    out: Dict[str, dict] = {}
    for parts, sample in _iter_vcf_records(vcf_file):
        ref, alts = parts[3], parts[4].split(",")
        if any(len(ref) != len(a) for a in alts):
            continue
        gt, _ = _gt_tuple(sample.get("GT", "."))
        if gt in ((0, 1), (1, 0)):
            out[f"{parts[0]}:{parts[1]}"] = {"gt": gt, "ref": ref, "alt": alts[0]}
    return out


def load_longcallr_phased_vcf(vcf_file: str, with_dp_af: bool = False
                              ) -> Dict[str, List[str]]:
    """PS → ["chr:pos(:dp:af)"] for PASS phased hets (:411-441)."""
    out: Dict[str, List[str]] = defaultdict(list)
    for parts, sample in _iter_vcf_records(vcf_file):
        if parts[6] != "PASS":
            continue
        ref, alts = parts[3], parts[4].split(",")
        if any(len(ref) != len(a) for a in alts):
            continue
        gt, phased = _gt_tuple(sample.get("GT", "."))
        if gt not in ((0, 1), (1, 0)) or not phased:
            continue
        ps = sample.get("PS")
        if ps and ps != ".":
            # keys must match the integer PS aux tags read from the BAM
            # (pysam-typed Integer FORMAT fields are ints in the reference)
            try:
                ps = int(ps)
            except ValueError:
                pass
            if with_dp_af:
                try:
                    dp = int(sample["DP"])
                    af = float(sample["AF"].split(",")[0])
                except (KeyError, ValueError):
                    continue
                if math.isnan(af) or dp == 0:
                    continue
                out[ps].append(f"{parts[0]}:{parts[1]}:{dp}:{af}")
            else:
                out[ps].append(f"{parts[0]}:{parts[1]}")
    return out


# ---------------------------------------------------------------------------
# per-gene ASE
# ---------------------------------------------------------------------------

def get_reads_tag(bam: BamFile, chrom: str, start: int, end: int) -> Dict[str, dict]:
    """read → {PS, HP} over a 1-based region (:444-451)."""
    out: Dict[str, dict] = {}
    for r in bam.fetch(chrom, start, end):
        out[r.qname] = {"PS": r.get_tag("PS"), "HP": r.get_tag("HP")}
    return out


def _ps_order(ps):
    """Deterministic sort key over heterogeneous PS ids (ints from BAM aux
    tags; strings like "." can appear in VCF-derived keys)."""
    return (0, ps, "") if isinstance(ps, int) else (1, 0, str(ps))


def _dominant_ps(reads_tag, assigned: Set[str]):
    """Phase set with the most assigned reads (longcallR-ase.py:457-472).
    The reference resolves count ties by set/dict iteration order
    (nondeterministic across runs under hash randomization); here ties go
    to the smallest PS id — documented (PARITY.md deviation #10)."""
    ps_hap: Dict[object, Dict[int, int]] = defaultdict(lambda: {1: 0, 2: 0})
    for rname in assigned:
        t = reads_tag.get(rname)
        if t and t["PS"] and t["HP"]:
            ps_hap[t["PS"]][t["HP"]] += 1
    if not ps_hap:
        return None, None
    best_cnt = max(c[1] + c[2] for c in ps_hap.values())
    best = min((ps for ps, c in ps_hap.items() if c[1] + c[2] == best_cnt),
               key=_ps_order)
    return best, ps_hap[best]


def calculate_ase_pvalue(bam, gene_id, gene_name, gene_region, min_count,
                         overdispersion, gene_assigned_reads):
    reads_tag = get_reads_tag(bam, gene_region["chr"], gene_region["start"],
                              gene_region["end"])
    assigned = set(gene_assigned_reads[gene_id])
    ps, hap = _dominant_ps(reads_tag, assigned)
    if ps is None:
        return (gene_name, gene_region["chr"], 1.0, ".", 0, 0)
    if hap[1] + hap[2] < min_count:
        return (gene_name, gene_region["chr"], 1.0, ps, 0, 0)
    p = beta_binomial_two_sided(hap[1], hap[1] + hap[2], 0.5, overdispersion)
    return (gene_name, gene_region["chr"], p, ps, hap[1], hap[2])


def calculate_ase_pvalue_pat_mat(bam, gene_id, gene_name, gene_region,
                                 min_count, overdispersion,
                                 gene_assigned_reads, rna_vcfs, wg_vcfs):
    """:481-553 — plus pat/mat resolution via the phased DNA VCF."""
    chrom = gene_region["chr"]
    reads_tag = get_reads_tag(bam, chrom, gene_region["start"], gene_region["end"])
    assigned = set(gene_assigned_reads[gene_id])
    ps, hap = _dominant_ps(reads_tag, assigned)
    if ps is None:
        return (gene_name, chrom, 1.0, ".", 0, 0, 0, 0, 0, 0)
    h1c, h2c = hap[1], hap[2]
    if h1c + h2c < min_count:
        return (gene_name, chrom, 1.0, ".", 0, 0, 0, 0, 0, 0)
    p = beta_binomial_two_sided(h1c, h1c + h2c, 0.5, overdispersion)

    ps_variants = rna_vcfs.get(ps, [])
    ps_reads = {r for r in assigned
                if r in reads_tag and reads_tag[r]["PS"] == ps}
    h1_reads = [r for r in ps_reads if reads_tag[r]["HP"] == 1]
    h2_reads = [r for r in ps_reads if reads_tag[r]["HP"] == 2]
    var_pos0 = sorted({int(v.split(":")[1]) - 1 for v in ps_variants
                       if f"{chrom}:{v.split(':')[1]}" in wg_vcfs})
    pos_arr = np.asarray(var_pos0, dtype=np.int64)
    pat_mat: Dict[str, Dict[str, int]] = defaultdict(lambda: {"pat": 0, "mat": 0})
    if pos_arr.size:
        for r in bam.fetch(chrom, gene_region["start"] - 1, gene_region["end"]):
            # pysam pileup's default stepper drops UNMAP/SECONDARY/QCFAIL/
            # DUP records (longcallR-ase.py:518 pileup vs this per-read walk)
            if r.flag & 0x704:
                continue
            if r.qname not in ps_reads:
                continue
            covered, bases = aligned_bases_at(r, pos_arr)
            for j in np.nonzero(covered)[0]:
                key = f"{chrom}:{int(pos_arr[j]) + 1}"
                base = chr(bases[j])
                if base in wg_vcfs[key]["pat"]:
                    pat_mat[r.qname]["pat"] += 1
                elif base in wg_vcfs[key]["mat"]:
                    pat_mat[r.qname]["mat"] += 1

    def tally(reads):
        pat = mat = 0
        for r in reads:
            c = pat_mat.get(r)
            if not c:
                continue
            if c["pat"] > c["mat"]:
                pat += 1
            elif c["pat"] < c["mat"]:
                mat += 1
        return pat, mat

    h1_pat, h1_mat = tally(h1_reads)
    h2_pat, h2_mat = tally(h2_reads)
    return (gene_name, chrom, p, ps, h1c, h2c, h1_pat, h1_mat, h2_pat, h2_mat)


def calculate_ase_pvalue_filtering(bam, gene_id, gene_name, gene_region,
                                   min_count, overdispersion,
                                   gene_assigned_reads, rna_vcfs, dna_vcfs):
    """:556-597 — keep only genes whose phase-set variants have DNA support."""
    chrom = gene_region["chr"]
    reads_tag = get_reads_tag(bam, chrom, gene_region["start"], gene_region["end"])
    assigned = set(gene_assigned_reads[gene_id])
    ps, hap = _dominant_ps(reads_tag, assigned)
    if ps is None:
        return (gene_name, chrom, 1.0, ".", 0, 0)
    h1c, h2c = hap[1], hap[2]
    if h1c + h2c < min_count:
        return (gene_name, chrom, 1.0, ps, 0, 0)
    p = beta_binomial_two_sided(h1c, h1c + h2c, 0.5, overdispersion)
    overlapped = 0
    for snp in rna_vcfs.get(ps, []):
        f = snp.split(":")
        if f"{f[0]}:{f[1]}" in dna_vcfs:
            depth = int(f[2])
            af = float(f[3])
            alt_cnt = int(depth * af)
            p_allele = beta_binomial_two_sided(alt_cnt, depth, 0.5, overdispersion)
            if depth >= min_count and p_allele < 0.05:
                overlapped += 1
    if overlapped == 0:
        return (gene_name, chrom, 1.0, ".", 0, 0)
    return (gene_name, chrom, p, ps, h1c, h2c)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def _write_results(results, out_file, min_support, extra_header="",
                   extra_fields=0):
    pass_idx, p_values = [], []
    for idx, row in enumerate(results):
        h1, h2 = row[4], row[5]
        if h1 + h2 >= min_support:
            pass_idx.append(idx)
            p_values.append(row[2])
    _, adjusted = fdr_bh(p_values, alpha=0.05)
    with open(out_file, "w") as f:
        f.write("#Gene_name\tChr\tPS\tH1\tH2\tP_value" + extra_header + "\n")
        for pi, idx in enumerate(pass_idx):
            row = results[idx]
            fields = [row[0], row[1], str(row[3]), str(row[4]), str(row[5]),
                      str(adjusted[pi])]
            fields += [str(x) for x in row[6:6 + extra_fields]]
            f.write("\t".join(fields) + "\n")


def analyze_ase_genes(annotation_file, bam_file, out_file, threads, gene_types,
                      min_support, overdispersion,
                      vcf1=None, vcf2=None, vcf3=None) -> None:
    gene_regions, gene_names, _, exon_regions = get_gene_regions(
        annotation_file, set(gene_types))
    merged = merge_gene_exon_regions(exon_regions)
    bam = BamFile(bam_file, threads=threads)
    read_assignment = assign_reads_to_gene(bam, merged, threads)
    gene_assigned = transform_read_assignment(read_assignment)
    results = []
    mode = "plain"
    if vcf1 and vcf2:
        mode = "patmat"
        rna_vcfs = load_longcallr_phased_vcf(vcf1)
        wg_vcfs = load_whole_genome_phased_vcf(vcf2)
    elif vcf1 and vcf3:
        mode = "filter"
        rna_vcfs = load_longcallr_phased_vcf(vcf1, with_dp_af=True)
        dna_vcfs = load_dna_vcf(vcf3)
    for gene_id in gene_regions:
        if gene_id not in gene_assigned:
            continue
        args = (bam, gene_id, gene_names[gene_id], gene_regions[gene_id],
                min_support, overdispersion, gene_assigned)
        if mode == "patmat":
            results.append(calculate_ase_pvalue_pat_mat(*args, rna_vcfs, wg_vcfs))
        elif mode == "filter":
            results.append(calculate_ase_pvalue_filtering(*args, rna_vcfs, dna_vcfs))
        else:
            results.append(calculate_ase_pvalue(*args))
    if mode == "patmat":
        _write_results(results, out_file, min_support,
                       "\tH1_Paternal\tH1_Maternal\tH2_Paternal\tH2_Maternal", 4)
    else:
        _write_results(results, out_file, min_support)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="longcallr-tpu-ase")
    parser.add_argument("-b", "--bam", required=True, help="phased BAM file")
    parser.add_argument("--vcf1", default=None, help="longcallR phased VCF")
    parser.add_argument("--vcf2", default=None, help="whole-genome phased DNA VCF")
    parser.add_argument("--vcf3", default=None, help="DNA VCF")
    parser.add_argument("-a", "--annotation", required=True)
    parser.add_argument("-d", "--overdispersion", type=float, default=0.001)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("-t", "--threads", type=int, default=1)
    parser.add_argument("--gene_types", type=str, nargs="+",
                        default=list(DEFAULT_GENE_TYPES))
    parser.add_argument("--min_support", type=int, default=10)
    args = parser.parse_args(argv)
    if args.vcf1 and args.vcf2:
        suffix = ".patmat_ase.tsv"
    elif args.vcf1 and args.vcf3:
        suffix = ".filter_ase.tsv"
    else:
        suffix = ".ase.tsv"
    analyze_ase_genes(args.annotation, args.bam, args.output + suffix,
                      args.threads, set(args.gene_types), args.min_support,
                      args.overdispersion, vcf1=args.vcf1, vcf2=args.vcf2,
                      vcf3=args.vcf3)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
