"""Candidate SNP selection: per-column torch kernel + host dense filter.

Port of ``longcallr_tpu/ops/candidates.py`` (itself a redesign of
``longcallR/src/candidate.rs:54-528``). Every column of a (padded) region
is evaluated at once on the given device: major-allele selection, the
filter chain, the 3-genotype likelihood from the pileup's pre-folded f64
log-qual sums, QUAL/GQ, and the edit/somatic/hom/het classification. The
dense-window passes run on the host over the short sorted candidate list.

Decision-relevant dtypes mirror the reference: allele frequencies and SOR
in f32, likelihood math in f64, counts in int64. The host parts
(``CandidateSet``, ``dense_mask``, ``_kernel_cols``, ``_pad_cols``,
``_candidates_from_out``) are copied from the JAX package, whose module
imports jax.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import CallerConfig
from ..tiles.pileup import PileupTensors

# tables and thresholds: the same numpy values as the JAX package
# (binomial two-tailed test for n <= 30 from scipy, SOR threshold in f32)
import math
from scipy.stats import binom as _scipy_binom

_THETA = 0.001
_PRIOR_LOG10 = (
    math.log10(_THETA / 2.0),      # hom var
    math.log10(_THETA),            # het var
    math.log10(1.0 - 1.5 * _THETA),  # hom ref
)
_LOG10_2 = math.log10(2.0)

_N = 31
_BINOM_CDF = np.zeros((_N, _N + 1), dtype=np.float64)
for _n in range(_N):
    _BINOM_CDF[_n, : _n + 1] = _scipy_binom.cdf(np.arange(_n + 1), _n, 0.5)
    _BINOM_CDF[_n, _n + 1:] = 1.0


def _binom_two_tailed_table() -> np.ndarray:
    """p_two_tail[n, k] for successes k of n trials at p=0.5."""
    tbl = np.zeros((_N, _N), dtype=np.float64)
    for n in range(_N):
        for k in range(n + 1):
            if k == 0:
                p = 2.0 * _BINOM_CDF[n, 0]
            elif k == n:
                p = 2.0 * (1.0 - (_BINOM_CDF[n, n - 1] if n >= 1 else 0.0))
            else:
                p = 2.0 * min(_BINOM_CDF[n, k], 1.0 - _BINOM_CDF[n, k - 1])
            tbl[n, k] = p
    return tbl


_BINOM_TWO_TAILED = _binom_two_tailed_table()

SOR_THRESHOLD = float(np.float32(
    np.log(np.float32((6.0 * 2.0) / (6.0 * 10.0) + (6.0 * 10.0) / (6.0 * 2.0)))
    + np.log(np.float32(6.0 / 6.0)) - np.log(np.float32(2.0 / 10.0))
))  # cal_strand_odds_ratio(5,5,9,1), candidate.rs:49-51

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _f32(x: float) -> float:
    """A threshold rounded to f32 (the reference compares in f32)."""
    return float(np.float32(x))


def _sor_f32(ref_fw, ref_rv, alt_fw, alt_rv):
    """GATK-style strand odds ratio with +1 pseudocounts, in f32 like
    candidate.rs:24-35."""
    x00 = (ref_fw + 1).float()
    x01 = (ref_rv + 1).float()
    x10 = (alt_fw + 1).float()
    x11 = (alt_rv + 1).float()
    sym = (x00 * x11) / (x01 * x10) + (x01 * x10) / (x00 * x11)
    ref_ratio = torch.minimum(x00, x01) / torch.maximum(x00, x01)
    alt_ratio = torch.minimum(x10, x11) / torch.maximum(x10, x11)
    return torch.log(sym) + torch.log(ref_ratio) - torch.log(alt_ratio)


def _take(a, idx):
    return torch.gather(a, 1, idx[:, None])[:, 0]


def candidate_kernel(cols: dict, cfg: CallerConfig) -> dict:
    """Evaluate every pileup column; returns per-column category + fields.

    ``cols``: torch tensors on one device — cnt[P,4], n_del[P],
    n_intron[P], ts[P,2], strands[P,4,2], s_err[P,4] f64, s_1merr[P,4] f64,
    bq_pass[P,4], ref_idx[P] (0-3 for uppercase ACGT else -1),
    exon_mask[P] bool.

    Category codes: 0 skip, 1 rna-edit, 2 somatic-candidate, 3 hom(/tri),
    4 het.
    """
    cnt = cols["cnt"].long()                       # [P,4]
    dev = cnt.device
    ref_idx = cols["ref_idx"].long()               # [P]
    cov = cnt.sum(dim=1)                           # total_allele_count
    ar4 = torch.arange(4, device=dev)
    i64, f32, f64 = torch.int64, torch.float32, torch.float64
    full = lambda v, like: torch.full_like(like, v)

    # --- two major alleles with ref-promotion quirk (util.rs:162-176) ---
    # desc sort by count, ties broken by allele order A<C<G<T (keys unique)
    key = cnt * 4 + (3 - ar4)[None, :]
    ordk = torch.argsort(-key, dim=1, stable=True)
    scnt = torch.gather(cnt, 1, ordk)
    x0, x1, x2, x3 = (ordk[:, i] for i in range(4))
    c0, c1_, c2_, c3_ = (scnt[:, i] for i in range(4))
    top2_has_ref = (x0 == ref_idx) | (x1 == ref_idx)
    promo2 = (~top2_has_ref) & (c2_ == c1_) & (x2 == ref_idx)
    promo3 = (~top2_has_ref) & (~promo2) & (c3_ == c1_) & (x3 == ref_idx)
    a1 = x0
    n1 = c0
    a2 = torch.where(promo2, x2, torch.where(promo3, x3, x1))
    n2 = torch.where(promo2, c2_, torch.where(promo3, c3_, c1_))
    covf = cov.to(f32)
    f1 = n1.to(f32) / covf
    f2 = n2.to(f32) / covf

    # --- ref / alt roles (candidate.rs:100-130) ---
    a1_is_ref = a1 == ref_idx
    a2_is_ref = a2 == ref_idx
    alt_num = torch.where(a1_is_ref | a2_is_ref, 1, 2)
    alt0 = torch.where(a1_is_ref, a2, a1)
    alt0_cnt = torch.where(a1_is_ref, n2, n1)
    alt0_freq = torch.where(a1_is_ref, f2, f1)
    alt1 = a2
    alt1_freq = f2

    ref_valid = ref_idx >= 0

    # --- filter chain (each term mirrors a `continue`) ---
    keep = cols["exon_mask"].bool()
    keep = keep & (cov >= cfg.min_depth) & (cov <= cfg.max_depth)
    low1 = ((alt_num == 1) & (cov < 200)
            & (alt0_freq < _f32(cfg.low_allele_frac_cutoff)))
    low2 = ((alt_num == 1) & (cov >= 200)
            & (alt0_cnt < cfg.low_allele_cnt_cutoff))
    keep = keep & ~(low1 | low2)
    n_del = cols["n_del"].long()
    keep = keep & (n_del < alt0_cnt)                      # candidate.rs:165-168
    depth_ii = (cov + n_del + cols["n_intron"].long()).to(f32)
    keep = keep & (((n1 + n2).to(f32) / depth_ii)
                   >= _f32(cfg.min_allele_freq_include_intron))

    # baseq pass: first non-ref major allele needs >=2 high-qual bases
    bqp = cols["bq_pass"].long()
    chk_allele = torch.where(~a1_is_ref, a1, a2)
    chk_cnt = torch.where(~a1_is_ref, n1, n2)
    chk_applies = (~a1_is_ref) | (~a2_is_ref)
    chk_bqp = _take(bqp, chk_allele)
    keep = keep & ~(chk_applies & (chk_cnt > 0) & (chk_bqp < 2))

    # --- strand bias (candidate.rs:199-234) ---
    if cfg.strand_bias:
        st = cols["strands"].long()                       # [P,4,2]
        take = lambda ai: (_take(st[:, :, 0], ai), _take(st[:, :, 1], ai))
        # when alt_num==2 the "reference allele" has count 0 but its
        # strands are still looked up by ref base
        ref_a = torch.where(a1_is_ref, a1,
                            torch.where(a2_is_ref, a2, ref_idx.clamp(min=0)))
        rf, rr = take(ref_a)
        af0, ar0 = take(alt0)
        sor0 = _sor_f32(rf, rr, af0, ar0)
        af1, ar1 = take(alt1)
        sor1 = _sor_f32(rf, rr, af1, ar1)
        sor = torch.where(alt_num == 2, torch.maximum(sor0, sor1), sor0)
        keep = keep & ~(sor > _f32(SOR_THRESHOLD))
        # binomial two-tailed for <=30 alt reads (alt_num==1 only)
        ntr = af0 + ar0
        tbl = torch.as_tensor(_BINOM_TWO_TAILED, device=dev)
        pbin = tbl[ntr.clamp(0, 30), af0.clamp(0, 30)]
        keep = keep & ~((alt_num == 1) & (ntr <= 30) & (pbin < 0.05))
        keep = keep & ~((alt_num == 1) & (af0 * ar0 == 0))

    keep = keep & ref_valid

    # --- genotype likelihood (candidate.rs:236-335), f64 ---
    s_err = cols["s_err"].to(f64)
    s_1m = cols["s_1merr"].to(f64)
    is_ref_ch = ar4[None, :] == ref_idx.clamp(min=0)[:, None]   # [P,4]
    ll0 = torch.where(is_ref_ch, s_err, s_1m).sum(dim=1)
    ll2 = torch.where(is_ref_ch, s_1m, s_err).sum(dim=1)
    ll1 = -cov.to(f64) * _LOG10_2
    lls = torch.stack([ll0, ll1, ll2], dim=1)             # [P,3]
    m20 = torch.tensor(-20.0, dtype=f64, device=dev)

    # log-domain normalisation (exponents clamped to [-20, 0]), as in the
    # JAX package
    def _log10_norm(lx):
        m = lx.max(dim=1, keepdim=True).values
        s = (10.0 ** torch.maximum(lx - m, m20)).sum(dim=1, keepdim=True)
        return (lx - m) - torch.log10(s)

    lp = lls + torch.tensor(_PRIOR_LOG10, dtype=f64, device=dev)[None, :]
    lvp = _log10_norm(lp)
    # reference: -10*log10(max(1e-300, vp[2])) (candidate.rs:312)
    variant_quality = -10.0 * torch.maximum(
        lvp[:, 2], torch.tensor(-300.0, dtype=f64, device=dev))
    lgp = _log10_norm(lls)
    phred = -10.0 * lgp
    # the reference's f64 underflow: gp below the smallest subnormal prints
    # GQ=inf (candidate.rs:319-335)
    phred = torch.where(phred > 3233.06, full(math.inf, phred), phred)
    ph_sorted = torch.sort(phred, dim=1).values
    genotype_quality = ph_sorted[:, 1] - ph_sorted[:, 0]
    gp = 10.0 ** torch.maximum(lgp, m20)

    # variant type via strict comparisons on the log values
    # (candidate.rs:359-371)
    vt = torch.where(
        (lgp[:, 0] > lgp[:, 1]) & (lgp[:, 0] > lgp[:, 2]), 2,
        torch.where((lgp[:, 1] > lgp[:, 0]) & (lgp[:, 1] > lgp[:, 2]), 1, 0))
    genotype = torch.where(vt == 2, -1, torch.where(vt == 1, 0, 1))

    keep = keep & (variant_quality >= float(cfg.min_qual))

    # --- classification (candidate.rs:379-455), in branch order ---
    ts = cols["ts"].long()
    ts_f, ts_r = ts[:, 0], ts[:, 1]
    ts_zero = (ts_f == 0) & (ts_r == 0)
    is_edit_ag = ((ref_idx == 0) & (alt0 == 2)
                  & ((ts_f > ts_r * 2) | ts_zero) & (vt != 2))
    is_edit_tc = ((ref_idx == 3) & (alt0 == 1)
                  & ((ts_r > ts_f * 2) | ts_zero) & (vt != 2))
    is_edit = is_edit_ag | is_edit_tc
    maf = _f32(cfg.min_allele_freq)
    is_somatic = (~is_edit) & (alt_num == 1) & (alt0_freq < maf)
    rest = (~is_edit) & (~is_somatic)
    tri_from_hom = (rest & (vt == 2) & (alt_num == 2)
                    & (alt0_freq >= maf) & (alt1_freq >= maf))
    tri_from_het = rest & (vt == 1) & (alt_num == 2)
    is_hom = rest & ((vt == 2) | tri_from_het)
    is_het = rest & (vt == 1) & (alt_num == 1)
    tri = tri_from_hom | tri_from_het
    vt_out = torch.where(tri, 3, vt)
    geno_out = torch.where(tri, -1, genotype)

    category = torch.where(
        ~keep, 0,
        torch.where(is_edit, 1,
                    torch.where(is_somatic, 2,
                                torch.where(is_hom, 3,
                                            torch.where(is_het, 4, 0)))))
    i8 = torch.int8
    return dict(
        category=category.to(i8),
        variant_type=vt_out.to(i8),
        genotype=geno_out.to(i8),
        allele1=a1.to(i8), allele2=a2.to(i8),
        freq1=f1, freq2=f2,
        alt0_freq=alt0_freq,
        alt1_freq=torch.where(alt_num == 2, alt1_freq,
                              torch.zeros_like(alt1_freq)),
        alt_num=alt_num.to(i8),
        depth=cov.to(torch.int32),
        variant_quality=variant_quality,
        genotype_quality=genotype_quality,
        genotype_prob=gp,
    )


@dataclass
class CandidateSet:
    """Struct-of-arrays over candidate SNPs of one region, position-sorted
    (the CandidateSNP vec equivalent, snp.rs:39-90). Same fields and dtypes
    as ``longcallr_tpu.ops.candidates.CandidateSet``."""

    chrom: str
    pos: np.ndarray              # [n] int64, 0-based
    ref_base: np.ndarray         # [n] uint8 ASCII
    alleles: np.ndarray          # [n,2] uint8 ASCII (major, minor)
    allele_freqs: np.ndarray     # [n,2] float32
    alt_frac: np.ndarray         # [n,2] float32
    depth: np.ndarray            # [n] int32
    variant_quality: np.ndarray  # [n] float64
    genotype_quality: np.ndarray  # [n] float64
    genotype_prob: np.ndarray    # [n,3] float64
    variant_type: np.ndarray     # [n] int8 (0 homref,1 het,2 hom,3 tri)
    genotype: np.ndarray         # [n] int8 (eta: -1 homvar, 0 het, 1 homref)
    haplotype: np.ndarray        # [n] int8 (delta: +-1, 0 unassigned)
    rna_editing: np.ndarray      # [n] bool
    cand_somatic: np.ndarray     # [n] bool
    dense: np.ndarray            # [n] bool
    hom_var: np.ndarray          # [n] bool
    het_var: np.ndarray          # [n] bool
    for_phasing: np.ndarray      # [n] bool
    single: np.ndarray           # [n] bool
    non_selected: np.ndarray     # [n] bool
    somatic: np.ndarray          # [n] bool
    somatic_score: np.ndarray    # [n] float64
    phase_score: np.ndarray      # [n] float64
    phase_set: np.ndarray        # [n] uint32

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    def idx_of(self, kind: str) -> np.ndarray:
        if kind == "het":
            return np.nonzero(self.het_var & ~self.dense)[0]
        if kind == "hom":
            return np.nonzero(self.hom_var & ~self.dense)[0]
        if kind == "edit":
            return np.nonzero(self.rna_editing)[0]
        if kind == "somatic":
            return np.nonzero(self.cand_somatic)[0]
        raise KeyError(kind)


def dense_mask(pos: np.ndarray, win: int, min_cnt: int, strict: bool) -> np.ndarray:
    """One dense-window pass over sorted candidate positions
    (candidate.rs:471-497 with ``diff > win``; the hard-coded second pass
    uses ``diff >= win`` — ``strict=False``). The tail case marks [i, j)
    with j = n-1, i.e. never the last element (reference quirk)."""
    n = len(pos)
    if n == 0:
        return np.zeros(0, dtype=bool)
    pos = np.asarray(pos, dtype=np.int64)
    j = np.searchsorted(pos, pos + win, side="right" if strict else "left")
    end = np.where(j < n, j, n - 1)
    cnt = np.where(j < n, j, n) - np.arange(n)
    starts = np.nonzero((cnt >= min_cnt) & (end > np.arange(n)))[0]
    diff = np.zeros(n + 1, dtype=np.int32)
    np.add.at(diff, starts, 1)
    np.add.at(diff, end[starts], -1)
    return np.cumsum(diff[:-1]) > 0


def _round_up(n: int, mult: int = 512) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _kernel_cols(pileup: PileupTensors,
                 exon_mask: Optional[np.ndarray]) -> dict:
    """Unpadded per-column kernel inputs for one region (numpy)."""
    P = pileup.length
    ref_idx = np.full(P, -1, dtype=np.int8)
    rb = pileup.ref_base
    for i, ch in enumerate(b"ACGT"):
        ref_idx[rb == ch] = i
    em = np.ones(P, dtype=bool) if exon_mask is None else exon_mask
    return dict(
        cnt=pileup.cnt, n_del=pileup.n_del,
        n_intron=pileup.n_intron, ts=pileup.ts,
        strands=pileup.strands, s_err=pileup.s_err,
        s_1merr=pileup.s_1merr, bq_pass=pileup.bq_pass,
        ref_idx=ref_idx, exon_mask=em,
    )


def _pad_cols(cols: dict, Ppad: int) -> dict:
    P = len(cols["ref_idx"])
    pad2 = lambda a: np.pad(a, [(0, Ppad - P)] + [(0, 0)] * (a.ndim - 1))
    out = {k: pad2(v) for k, v in cols.items()}
    out["ref_idx"] = np.pad(cols["ref_idx"], (0, Ppad - P),
                            constant_values=-1)
    return out


def _to_device(cols: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in cols.items()}


def select_candidates(pileup: PileupTensors, cfg: CallerConfig,
                      exon_mask: Optional[np.ndarray] = None,
                      device: torch.device = torch.device("cpu")
                      ) -> CandidateSet:
    """Full candidate selection for one region: pad → kernel on ``device``
    → host gather → dense-window passes → CandidateSet."""
    P = pileup.length
    cols = _pad_cols(_kernel_cols(pileup, exon_mask), _round_up(P))
    out = candidate_kernel(_to_device(cols, device), cfg)
    out = {k: v[:P].cpu().numpy() for k, v in out.items()}
    return _candidates_from_out(pileup, out, cfg)


def _candidates_from_out(pileup: PileupTensors, out: dict,
                         cfg: CallerConfig) -> CandidateSet:
    """Host gather of the kernel's per-column outputs (already sliced to the
    region's true length) → CandidateSet + dense-window passes."""
    rb = pileup.ref_base
    cat = out["category"]
    sel = np.nonzero(cat != 0)[0]
    n = sel.shape[0]
    start0 = pileup.region.start - 1
    cat_s = cat[sel]
    cs = CandidateSet(
        chrom=pileup.region.chr,
        pos=(sel + start0).astype(np.int64),
        ref_base=rb[sel].copy(),
        alleles=np.stack([_ACGT[out["allele1"][sel]], _ACGT[out["allele2"][sel]]], axis=1),
        allele_freqs=np.stack([out["freq1"][sel], out["freq2"][sel]], axis=1),
        alt_frac=np.stack([out["alt0_freq"][sel], out["alt1_freq"][sel]], axis=1),
        depth=out["depth"][sel],
        variant_quality=out["variant_quality"][sel],
        genotype_quality=out["genotype_quality"][sel],
        genotype_prob=out["genotype_prob"][sel],
        variant_type=out["variant_type"][sel],
        genotype=out["genotype"][sel],
        haplotype=np.zeros(n, np.int8),
        rna_editing=cat_s == 1,
        cand_somatic=cat_s == 2,
        dense=np.zeros(n, bool),
        hom_var=cat_s == 3,
        het_var=cat_s == 4,
        for_phasing=(cat_s == 3) | (cat_s == 4),
        single=np.zeros(n, bool),
        non_selected=np.zeros(n, bool),
        somatic=np.zeros(n, bool),
        somatic_score=np.zeros(n, np.float64),
        phase_score=np.zeros(n, np.float64),
        phase_set=np.zeros(n, np.uint32),
    )
    # dense-window passes over hom+het candidates (position order)
    ph_idx = np.nonzero(cs.hom_var | cs.het_var)[0]
    if ph_idx.size:
        ppos = cs.pos[ph_idx]
        d = dense_mask(ppos, cfg.dense_win_size, cfg.min_dense_cnt, strict=True)
        d |= dense_mask(ppos, 5, 3, strict=False)
        cs.dense[ph_idx[d]] = True
        cs.for_phasing[ph_idx[d]] = False
    return cs
