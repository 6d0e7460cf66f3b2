"""Frozen copy of ``tests/oracle_pileup.py`` at commit
fbeccaa9682300b9b3ab6ff3e33e50e6f6928b91: a literal
per-base transcription of the upstream pileup loop
(longcallR/src/util.rs:621-949). The pileup tensors and the log10 error
tables, which the original imports from the JAX package, are copied from
``longcallr_tpu_torch/tiles/pileup.py`` at the same commit."""

import numpy as np


from dataclasses import dataclass

from .config import CallerConfig, MAX_BASE_QUALITY

# base-quality -> log10 error tables, q capped at 30: error_rate =
# 0.1^(q/10) (candidate.rs:268), log10 taken in f64
_Q = np.arange(MAX_BASE_QUALITY + 1, dtype=np.float64)
ERR_RATE = 0.1 ** (_Q / 10.0)
with np.errstate(divide="ignore"):
    LOG10_ERR = np.log10(ERR_RATE)
    LOG10_1MERR = np.log10(1.0 - ERR_RATE)


@dataclass
class PileupTensors:
    """Dense per-region pileup statistics (the Profile equivalent)."""

    region: object
    ref_base: np.ndarray      # [P] uint8 ASCII (raw case)
    cnt: np.ndarray           # [P,4] int32 allele counts (A,C,G,T)
    n_intron: np.ndarray      # [P] int32 (CIGAR N)
    n_del: np.ndarray         # [P] int32 (CIGAR D)
    n_ins: np.ndarray         # [P] int32 (insertion at previous column)
    fwd: np.ndarray           # [P] int32 forward-strand kept bases
    bwd: np.ndarray           # [P] int32 reverse-strand kept bases
    strands: np.ndarray       # [P,4,2] int32 per-allele (fwd, rev)
    ts: np.ndarray            # [P,2] int32 transcript strand (fwd, rev)
    s_err: np.ndarray         # [P,4] float64 sum log10(err)   per allele
    s_1merr: np.ndarray       # [P,4] float64 sum log10(1-err) per allele
    bq_pass: np.ndarray       # [P,4] int32 count of baseq >= min_baseq

    @property
    def length(self) -> int:
        return self.ref_base.shape[0]

    def depth_acgt(self) -> np.ndarray:
        return self.cnt.sum(axis=1)


def _empty_tensors(region, ref_window: np.ndarray) -> PileupTensors:
    P = region.end - region.start
    return PileupTensors(
        region=region,
        ref_base=ref_window,
        cnt=np.zeros((P, 4), np.int32),
        n_intron=np.zeros(P, np.int32),
        n_del=np.zeros(P, np.int32),
        n_ins=np.zeros(P, np.int32),
        fwd=np.zeros(P, np.int32),
        bwd=np.zeros(P, np.int32),
        strands=np.zeros((P, 4, 2), np.int32),
        ts=np.zeros((P, 2), np.int32),
        s_err=np.zeros((P, 4), np.float64),
        s_1merr=np.zeros((P, 4), np.float64),
        bq_pass=np.zeros((P, 4), np.int32),
    )

_BASE_IDX = {65: 0, 97: 0, 67: 1, 99: 1, 71: 2, 103: 2, 84: 3, 116: 3}


def scalar_add_read(acc: PileupTensors, read, cfg: CallerConfig, qual_lists=None):
    """qual_lists: optional dict[(col, allele_idx)] -> list of capped baseqs,
    collected in read order (the BaseFreq.baseq Vec equivalent)."""
    region = acc.region
    vec_size = acc.length
    freq_vec_start_pos = region.start - 1
    seq = read.seq
    base_qual = read.qual
    strand = read.strand
    ts = read.get_tag("ts")
    start_pos = read.pos
    lead_sc = read.leading_softclips()
    trail_sc = read.trailing_softclips()
    L = cfg.polya_tail_length
    dist = cfg.distance_to_read_end

    pos_in_freq_vec = start_pos - freq_vec_start_pos
    pos_in_read = lead_sc if lead_sc > 0 else 0
    ops = read.cigar_ops.tolist()
    lens = read.cigar_lens.tolist()
    for op, ln in zip(ops, lens):
        ch = "MIDNSHP=X"[op]
        if ch in "SH":
            continue
        if ch in "M=X":
            broke = False
            for _ in range(ln):
                if pos_in_freq_vec < 0:
                    pos_in_freq_vec += 1
                    pos_in_read += 1
                    continue
                if pos_in_freq_vec >= vec_size:
                    broke = True
                    break
                base = seq[pos_in_read]
                baseq = min(int(base_qual[pos_in_read]), MAX_BASE_QUALITY)
                ref_base = int(acc.ref_base[pos_in_freq_vec])

                poly_a_flag = False
                homopolymer_flag = False
                trim_flag = False
                curr_pos = pos_in_read
                read_end_boundary = len(seq) - trail_sc
                if cfg.is_ont:
                    if (abs(curr_pos - lead_sc) < dist
                            or abs(curr_pos - read_end_boundary) < dist):
                        trim_flag = True
                if not trim_flag:
                    if (abs(curr_pos - lead_sc) < dist
                            or abs(curr_pos - read_end_boundary) < dist):
                        for tmpi in range(curr_pos - L, curr_pos + 2):
                            if tmpi < 0 or tmpi + L - 1 >= len(seq):
                                continue
                            poly_counts = [0, 0, 0, 0]  # A,T,C,G
                            for tmpj in range(L):
                                b = seq[tmpi + tmpj]
                                if b == 65 and ref_base != 65:
                                    poly_counts[0] += 1
                                elif b == 84 and ref_base != 84:
                                    poly_counts[1] += 1
                                elif b == 67 and ref_base != 67:
                                    poly_counts[2] += 1
                                elif b == 71 and ref_base != 71:
                                    poly_counts[3] += 1
                            if poly_counts[0] >= L or poly_counts[1] >= L:
                                poly_a_flag = True
                            if poly_counts[2] >= L or poly_counts[3] >= L:
                                homopolymer_flag = True

                if not trim_flag and not poly_a_flag and not homopolymer_flag:
                    p = pos_in_freq_vec
                    if strand == 0:
                        if ts == "+":
                            acc.ts[p, 0] += 1
                        elif ts == "-":
                            acc.ts[p, 1] += 1
                    else:
                        if ts == "+":
                            acc.ts[p, 1] += 1
                        elif ts == "-":
                            acc.ts[p, 0] += 1
                    bi = _BASE_IDX.get(int(base), -1)
                    if bi >= 0:
                        acc.cnt[p, bi] += 1
                        acc.strands[p, bi, strand] += 1
                        acc.s_err[p, bi] += LOG10_ERR[baseq]
                        acc.s_1merr[p, bi] += LOG10_1MERR[baseq]
                        if baseq >= cfg.min_baseq:
                            acc.bq_pass[p, bi] += 1
                        if qual_lists is not None:
                            qual_lists.setdefault((p, bi), []).append(baseq)
                    if strand == 0:
                        acc.fwd[p] += 1
                    else:
                        acc.bwd[p] += 1
                pos_in_freq_vec += 1
                pos_in_read += 1
            if broke:
                continue
        elif ch == "D":
            for _ in range(ln):
                if pos_in_freq_vec < 0:
                    pos_in_freq_vec += 1
                    continue
                if pos_in_freq_vec >= vec_size:
                    break
                acc.n_del[pos_in_freq_vec] += 1
                pos_in_freq_vec += 1
        elif ch == "I":
            if pos_in_freq_vec < 1:
                pos_in_read += ln
                continue
            if pos_in_freq_vec >= vec_size:
                break
            acc.n_ins[pos_in_freq_vec - 1] += 1
            pos_in_read += ln
        elif ch == "N":
            for _ in range(ln):
                if pos_in_freq_vec < 0:
                    pos_in_freq_vec += 1
                    continue
                if pos_in_freq_vec >= vec_size:
                    break
                acc.n_intron[pos_in_freq_vec] += 1
                pos_in_freq_vec += 1
        else:
            raise ValueError(ch)


def scalar_pileup(bam, region, ref_seq, cfg: CallerConfig, qual_lists=None) -> PileupTensors:
    start0 = region.start - 1
    acc = _empty_tensors(region, ref_seq[start0:region.end - 1].copy())
    for r in bam.fetch(region.chr, region.start, region.end):
        if (r.mapq < cfg.min_mapq or r.l_seq < cfg.min_read_length
                or r.is_unmapped or r.is_secondary or r.is_supplementary):
            continue
        de = r.get_tag("de")
        if isinstance(de, float) and de >= cfg.divergence:
            continue
        scalar_add_read(acc, r, cfg, qual_lists)
    return acc
