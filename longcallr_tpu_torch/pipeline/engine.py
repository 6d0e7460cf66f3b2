"""Per-region pipeline: pileup → candidates → fragments → phase → assign →
records, with the device stages on an explicit torch device. Mirrors the
region closure of the reference orchestrator
(``longcallR/src/thread.rs:77-222``).

Copied from ``longcallr_tpu/pipeline/engine.py`` (whose module imports jax
through the candidate kernel and the optimizer): ``process_region``, its
prepare stages and ``finalize_region`` (which the batched pipeline calls per
region after a bucket has phased), ``import_external_candidates``,
``RegionResult`` and the stage totals. The differences are the ``device``
argument, the torch candidate kernel and optimizer, and the stages' spans
(``utils/spans.py``, where ``STAGE_TOTALS`` and ``stage_add`` live).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import CallerConfig
from ..io.bam import BamFile
from ..io.vcf import GenotypeAndQuality, format_region_records
from ..tiles.pileup import build_pileup
from ..tiles.regions import Region

from ..ops.candidates import CandidateSet, select_candidates
from ..phasing import assign as A
from ..phasing.fragments import downsample_fragments, get_fragments
from ..phasing.optimize import phase_region
from ..utils.spans import STAGE_TOTALS, span  # noqa: F401


# keys of a run's stage dict that count events, not seconds: the bucket
# phasing's refusals, exact recomputes and bucket census, the enumeration
# waves' host syncs and regions (in STAGE_TOTALS), and the phase problems
# placed on the host, on the card and in float64 on the card (counted by
# utils/device.py, added by the caller)
STAGE_COUNTS = frozenset((
    "phase_fused_refused", "phase_blockflip_exact", "phase_safety_recompute",
    "phase_buckets", "phase_enum_buckets", "phase_single_regions",
    "phase_enum_wave_syncs", "phase_enum_wave_regions",
    "phase_host_placed", "phase_card_placed", "phase_card_f64_placed"))


def import_external_candidates(pileup, ref_seq: np.ndarray,
                               chr_cands: Dict[int, GenotypeAndQuality],
                               min_variant_qual: float = 0.0) -> CandidateSet:
    """candidate.rs:530-613: take candidate sites/genotypes from an input
    VCF instead of discovery. 0/0 records are dropped (no push in the
    reference either); 1/2 records become triallelic het-listed entries."""
    region = pileup.region
    start0 = region.start - 1
    rows: List[dict] = []
    for col in range(pileup.length):
        pos = start0 + col
        gq = chr_cands.get(pos)
        if gq is None or gq.genotype in (0, 4):
            continue
        if gq.quality < min_variant_qual:
            continue
        cnt4 = pileup.cnt[col]
        cov = int(cnt4.sum())
        ref_ch = chr(ref_seq[pos])
        # stable desc sort with ref-promotion (util.rs:162-176)
        x = sorted(zip("ACGT", cnt4.tolist()), key=lambda t: -t[1])
        a1, c1, a2, c2 = x[0][0], x[0][1], x[1][0], x[1][1]
        if a1 != ref_ch and a2 != ref_ch:
            if x[2][1] == x[1][1] and x[2][0] == ref_ch:
                a2, c2 = x[2][0], x[2][1]
            elif x[3][1] == x[1][1] and x[3][0] == ref_ch:
                a2, c2 = x[3][0], x[3][1]
        f1 = np.float32(c1) / np.float32(cov) if cov else np.float32(0)
        f2 = np.float32(c2) / np.float32(cov) if cov else np.float32(0)
        vt = {1: 1, 2: 2, 3: 3}[gq.genotype]
        geno = {1: 0, 2: -1, 3: -1}[gq.genotype]
        rows.append(dict(pos=pos, ref=ord(ref_ch), a1=ord(a1), a2=ord(a2),
                         f1=f1, f2=f2, depth=cov, qual=gq.quality, vt=vt,
                         geno=geno,
                         het=gq.genotype in (1, 3), hom=gq.genotype == 2))
    n = len(rows)
    g = lambda k, dt: np.asarray([r[k] for r in rows], dtype=dt)
    cs = CandidateSet(
        chrom=region.chr,
        pos=g("pos", np.int64) if n else np.zeros(0, np.int64),
        ref_base=g("ref", np.uint8) if n else np.zeros(0, np.uint8),
        alleles=(np.stack([g("a1", np.uint8), g("a2", np.uint8)], axis=1)
                 if n else np.zeros((0, 2), np.uint8)),
        allele_freqs=(np.stack([g("f1", np.float32), g("f2", np.float32)], axis=1)
                      if n else np.zeros((0, 2), np.float32)),
        alt_frac=np.zeros((n, 2), np.float32),
        depth=g("depth", np.int32) if n else np.zeros(0, np.int32),
        variant_quality=g("qual", np.float64) if n else np.zeros(0),
        genotype_quality=g("qual", np.float64) if n else np.zeros(0),
        genotype_prob=np.zeros((n, 3), np.float64),
        variant_type=g("vt", np.int8) if n else np.zeros(0, np.int8),
        genotype=g("geno", np.int8) if n else np.zeros(0, np.int8),
        haplotype=np.zeros(n, np.int8),
        rna_editing=np.zeros(n, bool),
        cand_somatic=np.zeros(n, bool),
        dense=np.zeros(n, bool),
        hom_var=g("hom", bool) if n else np.zeros(0, bool),
        het_var=g("het", bool) if n else np.zeros(0, bool),
        for_phasing=np.ones(n, bool),
        single=np.zeros(n, bool),
        non_selected=np.zeros(n, bool),
        somatic=np.zeros(n, bool),
        somatic_score=np.zeros(n, np.float64),
        phase_score=np.zeros(n, np.float64),
        phase_set=np.zeros(n, np.uint32),
    )
    return cs


@dataclass
class RegionResult:
    region: Region
    vcf_lines: List[str]
    read_assignments: Dict[str, int]
    phase_sets: Dict[str, int]
    n_fragments: int
    n_candidates: int


def prepare_region(bam: BamFile, region: Region, ref_seq: np.ndarray,
                   cfg: CallerConfig, device: torch.device,
                   input_candidates: Optional[Dict[str, Dict[int, GenotypeAndQuality]]] = None,
                   exon_mask: Optional[np.ndarray] = None):
    """Pileup → candidates (on ``device``) → fragments. Returns
    (cands, frags, apply_ds)."""
    pileup = prepare_region_pileup(bam, region, ref_seq, cfg)
    with span("region.candidates", key="candidates"):
        if input_candidates is not None:
            chr_cands = input_candidates.get(region.chr, {})
            cands = import_external_candidates(pileup, ref_seq, chr_cands)
        else:
            cands = select_candidates(pileup, cfg, exon_mask=exon_mask,
                                      device=device)
    frags, apply_ds = prepare_region_fragments(bam, region, cands, cfg)
    return cands, frags, apply_ds


def prepare_region_pileup(bam: BamFile, region: Region, ref_seq: np.ndarray,
                          cfg: CallerConfig):
    """Pileup stage alone (the batched pipeline runs candidates for a whole
    wave of regions in one kernel call — ops/candidates.py
    select_candidates_batched)."""
    with span("region.pileup", key="pileup"):
        return build_pileup(bam, region, ref_seq, cfg)


def prepare_region_fragments(bam: BamFile, region: Region, cands,
                             cfg: CallerConfig):
    """Fragment stage alone; returns (frags, apply_ds)."""
    with span("region.fragments", key="fragments"):
        frags = get_fragments(bam, region, cands, cfg)
        if cfg.somatic:
            # third-pass baseq gather at the candidate-time somatic snapshot
            # (snpfrags.rs:56-189); routed by assignment after phasing
            from ..phasing.fragments import gather_somatic_hap_quals
            frags.somatic_gather = gather_somatic_hap_quals(bam, region,
                                                            cands)
    apply_ds = (cfg.downsample and cfg.downsample_depth > 0
                and frags.n_frags >= cfg.downsample_depth)
    if apply_ds:
        downsample_fragments(frags, cfg.downsample_depth, 2025)
    return frags, apply_ds


def finalize_region(region: Region, cands, frags, st, cfg: CallerConfig,
                    apply_ds: bool) -> RegionResult:
    """Post-phasing passes: assignment, rescue, phase sets, records
    (thread.rs:168-221). ``st`` is the region's final PhaseState (host
    numpy), or None when there was nothing to phase. Host work only."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, region.start & 0x7FFFFFFF, 7]))
    if st is not None:
        frags.haplotag = np.sign(np.asarray(st.sigma)).astype(np.int8)
        cands.haplotype = np.sign(np.asarray(st.delta)).astype(np.int8)
        cands.genotype = np.asarray(st.eta).astype(np.int8)

        with span("region.assign", key="assign"):
            ct = A.cell_tables_lazy(frags)
            A.assign_reads_haplotype(frags, cands, cfg, ct, apply_ds)
            A.assign_snp_haplotype_genotype(frags, cands, cfg, ct, apply_ds)
            A.assign_reads_haplotype(frags, cands, cfg, ct, apply_ds)
            A.assign_snp_haplotype_genotype(frags, cands, cfg, ct, apply_ds)
            A.eval_rna_edit_var_phase(frags, cands, cfg, ct,
                                      cfg.min_phase_score - 3.0, apply_ds, rng)
            A.eval_low_frac_var_phase(frags, cands, cfg, ct,
                                      cfg.min_phase_score - 3.0, apply_ds, rng)
            read_assignments = A.assign_reads_haplotype(frags, cands, cfg,
                                                        ct, False)
            A.assign_snp_haplotype_genotype(frags, cands, cfg, ct, False)
            if cfg.somatic:
                # somatic-by-het (disabled in the reference default path,
                # thread.rs:185-187)
                from ..ops.somatic import detect_somatic_by_het
                detect_somatic_by_het(frags, cands, cfg.somatic_purity)
            phase_sets = A.assign_phase_set(frags, cands, cfg.min_phase_score)
    else:
        # no phasing possible; still run the SNP-state passes so
        # non_selected/single flags are set for VCF emission
        if cands.n > 0:
            ct = A.cell_tables_lazy(frags)
            A.assign_snp_haplotype_genotype(frags, cands, cfg, ct, False)
        read_assignments = {}
        phase_sets = {}

    with span("region.records", key="records"):
        vcf_lines = format_region_records(cands, cfg.min_phase_score)
    return RegionResult(region=region, vcf_lines=vcf_lines,
                        read_assignments=read_assignments,
                        phase_sets=phase_sets, n_fragments=frags.n_frags,
                        n_candidates=cands.n)


def process_region(bam: BamFile, region: Region, ref_seq: np.ndarray,
                   cfg: CallerConfig, device: torch.device,
                   input_candidates: Optional[Dict[str, Dict[int, GenotypeAndQuality]]] = None,
                   exon_mask: Optional[np.ndarray] = None) -> RegionResult:
    """One region end-to-end (thread.rs:77-222)."""
    cands, frags, apply_ds = prepare_region(bam, region, ref_seq, cfg, device,
                                            input_candidates, exon_mask)
    st = None
    if cands.n > 0 and frags.n_frags > 0:
        with span("region.phase", key="phase"):
            st = phase_region(frags, cands, cfg, seed=region.start,
                              apply_downsampling=apply_ds, device=device)
    return finalize_region(region, cands, frags, st, cfg, apply_ds)
