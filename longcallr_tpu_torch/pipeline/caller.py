"""Top-level caller: regions → per-region pipeline → VCF + phased BAM.

Port of the resident per-region path of
``longcallr_tpu/pipeline/caller.py`` (``longcallR/src/thread.rs:17-362``):
a thread pool over regions (one region per worker, single-threaded
inside), deterministic (contig, start)-ordered merges, and the serial
phased-BAM pass. Every device stage runs on the ``device`` given to
``run``.

Not ported in this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): the batched bucket pipeline (``batched=True``), ``--resume``
checkpoints, and the streaming and pod entry points. ``batched=None``
(AUTO) resolves to the per-region path, which the JAX package holds
byte-identical to the batched one.
"""

from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CallerConfig
from ..io.bam import (BamFile, BamWriter, tagged_record_indices,
                      write_tagged_records)
from ..io.fasta import FastaFile
from ..io.vcf import load_input_candidates, write_vcf_header
from ..phasing import optimize as _opt
from ..tiles.regions import Region, extract_isolated_regions_parallel
from .annotation import intersect_gene_regions, parse_annotation
from .engine import STAGE_TOTALS, RegionResult, process_region

log = logging.getLogger("longcallr_tpu_torch")

# ROADMAP.md "torch port" queue items for what this slice leaves out
BATCHED_ITEM = "ROADMAP.md torch port queue: batched bucket programs"
RESUME_ITEM = "ROADMAP.md torch port queue: --stream and --resume"


@dataclass
class CallerOutputs:
    vcf_path: str
    phased_bam_path: Optional[str]
    n_regions: int
    n_records: int
    n_reads_tagged: int
    stage_seconds: Dict[str, float] = field(default_factory=dict)
    n_phased_sites: int = 0
    n_assigned_reads: int = 0
    n_fragments: int = 0
    n_candidates: int = 0
    # split-mode regions decided by the split kernels / recomputed in f64
    # by the safety net
    n_split_kept: int = 0
    n_f64_reruns: int = 0


def build_regions(bam: BamFile, fasta: FastaFile, cfg: CallerConfig,
                  input_region: Optional[str] = None,
                  contigs: Optional[Sequence[str]] = None,
                  anno_path: Optional[str] = None
                  ) -> Tuple[List[Region], Dict[str, List[Tuple[int, int]]]]:
    """main.rs:187-226 (copied from the JAX package's caller)."""
    if input_region is not None:
        regions = [Region.parse(input_region)]
    else:
        regions = extract_isolated_regions_parallel(
            bam, fasta.contig_lengths, cfg, contigs=contigs)
    gene_regions: Dict[str, List[Region]] = {}
    exon_regions: Dict[str, List[Tuple[int, int]]] = {}
    if anno_path:
        gene_regions, exon_regions = parse_annotation(anno_path)
    if cfg.exon_only:
        if not anno_path:
            raise ValueError("exon_only is set, but annotation file is not provided")
        regions = intersect_gene_regions(regions, gene_regions, merge=True)
    return regions, exon_regions


def _exon_mask_for(reg: Region, exon_regions: Dict[str, List[Tuple[int, int]]]):
    """Exon coverage mask over the region window (thread.rs:80-92 +
    candidate.rs:80-89). Returns None when no exon covers the region's genes."""
    invs: List[Tuple[int, int]] = []
    for gene_id in (reg.gene_id or "").split(","):
        invs.extend(exon_regions.get(gene_id, []))
    if not invs:
        return None
    P = reg.end - reg.start
    mask = np.zeros(P + 1, dtype=np.int32)
    for s, e in invs:  # 1-based [s, e) intervals
        lo = max(0, s - reg.start)
        hi = min(P, e - reg.start)
        if lo < hi:
            mask[lo] += 1
            mask[hi] -= 1
    return np.cumsum(mask[:-1]) > 0


def run(bam_path: str, ref_path: str, output_prefix: str, cfg: CallerConfig,
        input_vcf: Optional[str] = None, input_region: Optional[str] = None,
        contigs: Optional[Sequence[str]] = None,
        anno_path: Optional[str] = None,
        resume: bool = False, batched: Optional[bool] = None,
        device: torch.device = torch.device("cpu")) -> CallerOutputs:
    """Resident per-region run on ``device``."""
    if batched:
        raise NotImplementedError(f"batched pipeline not ported ({BATCHED_ITEM})")
    if resume:
        raise NotImplementedError(f"--resume not ported ({RESUME_ITEM})")
    device = torch.device(device)
    t0 = time.monotonic()
    stage: Dict[str, float] = {}
    totals0 = dict(STAGE_TOTALS)
    kept0, reruns0 = _opt.N_SPLIT_KEPT, _opt.N_F64_RERUNS
    # -r chr:start-end + a .bai beside the BAM → BAI-windowed load
    window = None
    if input_region is not None:
        r = Region.parse(input_region)
        if r.start < r.end:   # bare-contig regions load the whole stream
            window = (r.chr, max(0, r.start - 1), r.end)
    bam = BamFile(bam_path, threads=max(1, cfg.threads), region=window)
    fasta = FastaFile(ref_path)
    stage["load"] = time.monotonic() - t0

    t1 = time.monotonic()
    regions, exon_regions = build_regions(bam, fasta, cfg, input_region,
                                          contigs, anno_path)
    stage["regions"] = time.monotonic() - t1
    log.info("discovered %d regions", len(regions))

    input_candidates = (load_input_candidates(input_vcf)
                        if input_vcf is not None else None)

    t2 = time.monotonic()
    # one region per pool worker, single-threaded inside (the rayon layout)
    cfg_task = (cfg.replace(threads=1)
                if cfg.threads > 1 and len(regions) > 1 else cfg)

    def work(reg: Region) -> RegionResult:
        ref_seq = fasta.fetch(reg.chr)
        exon_mask = None
        if cfg.exon_only and reg.gene_id is not None:
            exon_mask = _exon_mask_for(reg, exon_regions)
            if exon_mask is None:
                return RegionResult(reg, [], {}, {}, 0, 0)
        res = process_region(bam, reg, ref_seq, cfg_task, device,
                             input_candidates=input_candidates,
                             exon_mask=exon_mask)
        if res.n_fragments > 0:
            log.info("region %s: %d fragments, %d candidates",
                     reg, res.n_fragments, res.n_candidates)
        return res

    # warm the per-contig reference cache serially to avoid duplicate loads
    for chrom in {r.chr for r in regions}:
        fasta.fetch(chrom)
    if cfg.threads > 1 and len(regions) > 1:
        with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
            results = list(ex.map(work, regions))
    else:
        results = [work(r) for r in regions]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stage["regions_pipeline"] = time.monotonic() - t2

    # --- VCF (deterministic contig order, then region order) ---
    t3 = time.monotonic()
    order = {c: i for i, (c, _) in enumerate(fasta.contig_lengths)}
    results_sorted = sorted(
        zip(regions, results),
        key=lambda t: (order.get(t[0].chr, 1 << 30), t[0].start))
    vcf_path = output_prefix + ".vcf"
    n_records = 0
    n_phased = 0
    with open(vcf_path, "w") as vf:
        write_vcf_header(vf, fasta.contig_lengths)
        for _, res in results_sorted:
            for line in res.vcf_lines:
                vf.write(line + "\n")
                n_records += 1
                gt = line.split("\t")[9].split(":", 1)[0]
                if gt in ("0|1", "1|0"):
                    n_phased += 1
    stage["vcf"] = time.monotonic() - t3

    # --- phased BAM, serial pass (thread.rs:307-361) ---
    phased_bam_path = None
    n_tagged = 0
    if not cfg.no_bam_output:
        t4 = time.monotonic()
        read_assignments: Dict[str, int] = {}
        read_phasesets: Dict[str, int] = {}
        for _, res in results_sorted:  # first-wins merges (thread.rs:309-325)
            for k, v in res.read_assignments.items():
                read_assignments.setdefault(k, v)
            for k, v in res.phase_sets.items():
                read_phasesets.setdefault(k, v)
        phased_bam_path = output_prefix + ".phased.bam"
        with BamWriter(phased_bam_path, bam.references, bam.lengths,
                       header_text=bam.header_text,
                       level=cfg.bam_compression_level,
                       threads=max(1, cfg.threads)) as w:
            for reg, _ in results_sorted:
                ridxs = tagged_record_indices(bam, reg.chr, reg.start,
                                              reg.end).tolist()
                n_tagged += write_tagged_records(
                    bam, ridxs, read_assignments, read_phasesets, w)
        stage["phased_bam"] = time.monotonic() - t4

    stage["total"] = time.monotonic() - t0
    # cumulative seconds of the per-region stages (summed over threads)
    for k, v in STAGE_TOTALS.items():
        stage[f"region_{k}"] = v - totals0.get(k, 0.0)
    n_assigned = sum(1 for _, res in results_sorted
                     for v in res.read_assignments.values() if v != 0)
    return CallerOutputs(vcf_path=vcf_path, phased_bam_path=phased_bam_path,
                         n_regions=len(regions), n_records=n_records,
                         n_reads_tagged=n_tagged, stage_seconds=stage,
                         n_phased_sites=n_phased, n_assigned_reads=n_assigned,
                         n_fragments=sum(r.n_fragments for _, r in results_sorted),
                         n_candidates=sum(r.n_candidates for _, r in results_sorted),
                         n_split_kept=_opt.N_SPLIT_KEPT - kept0,
                         n_f64_reruns=_opt.N_F64_RERUNS - reruns0)
