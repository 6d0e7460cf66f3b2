"""Read/SNP assignment, rescue passes, and phase sets.

Vectorised redesign of ``longcallR/src/snpfrags.rs``:
  * assign_reads_haplotype (snpfrags.rs:548-625): per-read surrogate q vs
    flipped q over {for_phasing, haplotyped, het} columns, with the
    read-assignment-diff cutoff;
  * assign_snp_haplotype_genotype (snpfrags.rs:378-546): per-SNP 4-way
    (δ, η) re-argmax with variant-type-dependent read gathers, phase score
    with the 0.19940219 sentinel;
  * eval_rna_edit_var_phase / eval_low_frac_var_phase (snpfrags.rs:191-376):
    rescue of edit/low-frac candidates at a relaxed threshold;
  * assign_phase_set (snpfrags.rs:628-733): consistency graph + connected
    components; PS id = 1-based position of the smallest-position SNP in the
    component (the reference takes the first node of the kosaraju component,
    whose order is unspecified — see SURVEY.md §4).

State lives in the CandidateSet / FragmentMatrix numpy arrays; the masked
sums are host numpy.

Copied from ``longcallr_tpu/phasing/assign.py``; the imports differ
(``CandidateSet``/``CellTables`` come from the torch package) and the
unused jax import is dropped.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import CallerConfig

from ..ops.candidates import CandidateSet
from .fragments import FragmentMatrix
from .kernels import CellTables

PHASE_SCORE_SENTINEL = 0.19940219  # snpfrags.rs:486


def _cell_terms(ct: CellTables):
    p = np.asarray(ct.p)
    l1m = np.asarray(ct.l1m)
    lerr = np.asarray(ct.lerr)
    return p, l1m, lerr


# Per-region GEMM tables. l1m/lerr are 0 at non-cells, so with
# Tp = (p==+1 ? l1m : lerr) and Tm = (p==-1 ? l1m : lerr) every masked
# where-sum of the assignment layer is a plain matrix product: row masks
# (read groups) fold into a small G matrix on the left, column masks
# (δ-sign groups) into a weight matrix on the right. T4 stacks
# [Tp | Tm | lerr | |p|] as one [K, 4I] operand so each pass is a single
# GEMM instead of ~20 [K,I] temporaries. Sum order changes from the naive
# axis-sums only by f64 reassociation (oracle-tested at 1e-12).
#
# The cache is a thread-local single entry: a ct only repeats within one
# region's run of assignment passes (engine.py builds a fresh ct per
# region), so one slot per worker thread gives all the hits with no
# retention of completed regions' [K,4I] tables.
import threading as _threading

_t4_local = _threading.local()


def _t4(ct: CellTables) -> np.ndarray:
    hit = getattr(_t4_local, "entry", None)
    if hit is not None and hit[0] is ct.p:
        return hit[1]
    p, l1m, lerr = _cell_terms(ct)
    tp = np.where(p == 1.0, l1m, lerr)
    tm = np.where(p == -1.0, l1m, lerr)
    t4 = np.concatenate([tp, tm, lerr, np.abs(p)], axis=1)
    _t4_local.entry = (ct.p, t4)
    return t4


def _native_assign_lib():
    """The native cell-histogram kernels, or None (→ GEMM fallback).
    LONGCALLR_NATIVE_ASSIGN=0 forces the numpy path."""
    import os

    if os.environ.get("LONGCALLR_NATIVE_ASSIGN", "1") == "0":
        return None
    from .. import native

    nlib = native.lib()
    if nlib is None or not hasattr(nlib, "assign_group_hist"):
        return None
    return nlib


from .kernels import LOG10_1MERR_T as _L1M_T, LOG10_ERR_T as _LERR_T

_N_Q = _L1M_T.shape[0]


def _group_sums_hist(nlib, frags: FragmentMatrix,
                     read_mask: np.ndarray) -> np.ndarray:
    """Histogram form of :func:`_group_sums`: one native pass over the CSR
    cells builds integer counts H[6][I][2][n_q]; the f64 combination with
    the log10 tables is a fixed-order [*,n_q]·[n_q] contraction. Differs
    from the GEMM form only by f64 reassociation (same class of deviation
    the GEMM form has vs the reference's scalar loop; oracle-gated at
    1e-12)."""
    import ctypes

    K, I = frags.p.shape
    off, ci, cp, cq = frags.flat_cells()
    sig = frags.haplotag
    asg = frags.assignment
    scode = np.where(sig == 1, 0, np.where(sig == -1, 1, 2))
    acode = np.where(asg == 1, 1, np.where(asg == 2, 2, 0))
    gcode = np.where(read_mask, scode | (acode << 2), 0xFF).astype(np.uint8)
    H = np.zeros((6, I, 2, _N_Q), np.int32)
    nlib.assign_group_hist(
        K, I,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cp.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        cq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        gcode.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _N_Q, H.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), 4)
    Hp = H[:, :, 0, :].astype(np.float64)   # [6, I, n_q] allele = +1 counts
    Hm = H[:, :, 1, :].astype(np.float64)
    # l1m[0] = -inf (q=0 → err=1): a zero count times -inf would NaN the
    # dot, so contract over q >= 1 and re-apply -inf where q=0 cells exist
    A = Hp[:, :, 1:] @ _L1M_T[1:] + Hm @ _LERR_T
    B = Hm[:, :, 1:] @ _L1M_T[1:] + Hp @ _LERR_T
    A[Hp[:, :, 0] > 0] = -np.inf
    B[Hm[:, :, 0] > 0] = -np.inf
    N = Hp + Hm
    E = N @ _LERR_T
    C = N.sum(axis=2)
    return np.concatenate([A, B, E, C], axis=1)


def cell_tables_lazy(frags: FragmentMatrix) -> Optional[CellTables]:
    """The expanded [K,I] f64 cell tables, or None when the native
    histogram kernels make them unnecessary (they read the CSR cells and
    the log10 tables directly). Callers pass the result straight through
    to the assign functions; the GEMM fallback rebuilds on demand."""
    if _native_assign_lib() is not None:
        return None
    from .kernels import make_cell_tables_np

    return make_cell_tables_np(frags.p, frags.baseq)


def _ct_or_build(frags: FragmentMatrix,
                 ct: Optional[CellTables]) -> CellTables:
    if ct is None:
        from .kernels import make_cell_tables_np

        ct = make_cell_tables_np(frags.p, frags.baseq)
    return ct


def _group_sums(frags: FragmentMatrix, ct: Optional[CellTables],
                read_mask: np.ndarray) -> np.ndarray:
    """[6, 4I] row-group sums over masked reads: rows = σ=+1, σ=−1, σ=0,
    assignment==1, assignment==2, all; column blocks = Tp, Tm, lerr, |p|."""
    nlib = _native_assign_lib()
    if nlib is not None:
        return _group_sums_hist(nlib, frags, read_mask)
    t4 = _t4(_ct_or_build(frags, ct))
    sig = frags.haplotag
    G = np.stack([read_mask & (sig == 1), read_mask & (sig == -1),
                  read_mask & (sig == 0),
                  read_mask & (frags.assignment == 1),
                  read_mask & (frags.assignment == 2),
                  read_mask]).astype(np.float64)
    return G @ t4


def assign_reads_haplotype(frags: FragmentMatrix, cands: CandidateSet,
                           cfg: CallerConfig, ct: CellTables,
                           apply_downsampling: bool) -> Dict[str, int]:
    """snpfrags.rs:548-625. Mutates frags.{haplotag, assignment,
    assignment_score}; returns read_id → 0/1/2."""
    K, I = frags.p.shape
    col = (cands.for_phasing & (cands.haplotype != 0)
           & (cands.genotype == 0))
    delta = cands.haplotype.astype(np.float64)
    # all gathered cells have eta==0 → x = σ·δ. Column δ-sign groups fold
    # into one [4I, 3] weight matrix against the cached T4 tables:
    # tp = Σ_i col·(δ>0 ? Tp : δ<0 ? Tm : lerr), tm the mirror, plus cov.
    nlib = _native_assign_lib()
    if nlib is not None:
        import ctypes

        off, ci, cpv, cq = frags.flat_cells()
        dcode = np.where(col, np.where(delta > 0, 1,
                                       np.where(delta < 0, 2, 3)),
                         0).astype(np.int8)
        tp = np.zeros(K)
        tm = np.zeros(K)
        nc = np.zeros(K, np.int32)
        nlib.assign_read_sums(
            K,
            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cpv.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            cq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            dcode.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            _N_Q,
            _L1M_T.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _LERR_T.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tm.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            nc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        ncells = nc.astype(np.float64)
    else:
        cp = (col & (delta > 0)).astype(np.float64)
        cm = (col & (delta < 0)).astype(np.float64)
        cz = (col & (delta == 0)).astype(np.float64)
        z = np.zeros(I)
        W = np.stack([np.concatenate([cp, cm, cz, z]),
                      np.concatenate([cm, cp, cz, z]),
                      np.concatenate([z, z, z, col.astype(np.float64)])],
                     axis=1)
        S = _t4(_ct_or_build(frags, ct)) @ W   # [K, 3]
        tp, tm, ncells = S[:, 0], S[:, 1], S[:, 2]
    d = tp + tm

    ds = frags.downsampled if apply_downsampling else np.ones(K, bool)
    active = frags.for_phasing & ds
    sigma = frags.haplotag.astype(np.int8)
    live = active & (sigma != 0) & (ncells != 0)
    plus = sigma == 1
    with np.errstate(invalid="ignore", divide="ignore"):
        q = 1.0 - np.where(plus, tp, tm) / d
        qn = 1.0 - np.where(plus, tm, tp) / d
    decided = live & (np.abs(q - qn) >= cfg.min_read_assignment_diff)
    keep_cur = q >= qn
    asg = np.where(decided,
                   np.where(keep_cur, np.where(plus, 1, 2),
                            np.where(plus, 2, 1)),
                   0).astype(np.int8)
    frags.assignment[active] = asg[active]
    frags.assignment_score[active] = np.where(
        decided, np.where(keep_cur, q, qn), 0.0)[active]
    frags.haplotag[active] = np.where(
        decided, np.where(keep_cur, sigma, -sigma), 0)[active].astype(np.int8)
    from itertools import compress
    al = active.tolist()
    return dict(zip(compress(frags.qnames, al),
                    (int(a) for a in compress(asg.tolist(), al))))


def _column_sums(frags: FragmentMatrix, ct: CellTables, read_mask: np.ndarray,
                 delta: np.ndarray, gs: Optional[np.ndarray] = None):
    """Per-SNP masked sums over cells of reads in read_mask[K]:
    returns (S_match(δ), S_flip, S_refe, S_alte, cov, n_hap1, n_hap2).
    With x = σ_k·δ_i, the emission term is Tp when x=+1, Tm when x=−1 and
    lerr when x=0, so every sum is a combination of the σ-group rows of
    :func:`_group_sums` selected by the sign of δ."""
    K, I = frags.p.shape
    if gs is None:
        gs = _group_sums(frags, ct, read_mask)
    A = gs[:, 0:I]          # Σ Tp per σ-group / assignment rows
    B = gs[:, I:2 * I]      # Σ Tm
    E = gs[:, 2 * I:3 * I]  # Σ lerr
    C = gs[:, 3 * I:]       # Σ |p| (cell counts)
    dp = delta > 0
    dm = delta < 0
    mz = E[0] + E[1]
    s_match = np.where(dp, A[0] + B[1],
                       np.where(dm, B[0] + A[1], mz)) + E[2]
    s_flip = np.where(dp, B[0] + A[1],
                      np.where(dm, A[0] + B[1], mz)) + E[2]
    s_refe = A[0] + A[1] + A[2]
    s_alte = B[0] + B[1] + B[2]
    cov = C[5].astype(np.int64)
    n_h1 = C[3].astype(np.int64)
    n_h2 = C[4].astype(np.int64)
    return s_match, s_flip, s_refe, s_alte, cov, n_h1, n_h2


def _snp_qs_np(s_match, s_flip, s_refe, s_alte, cov):
    ph = np.where(cov == 0, math.log10(0.001),
                  math.log10(0.001) - cov * math.log10(2.0))
    p_homref = math.log10(1.0 - 1.5 * 0.001)
    p_homvar = math.log10(0.5 * 0.001)
    n1 = s_match + ph
    n2 = s_flip + ph
    n3 = s_refe + p_homref
    n4 = s_alte + p_homvar
    d = n4 + n1 + n3 + n2
    with np.errstate(invalid="ignore"):
        return 1.0 - n1 / d, 1.0 - n2 / d, 1.0 - n3 / d, 1.0 - n4 / d


def _phase_score_cols(frags: FragmentMatrix, ct: CellTables,
                      read_mask, delta_sign: np.ndarray,
                      gs: Optional[np.ndarray] = None) -> np.ndarray:
    """-10·log10(1 - cal_phase_score_log(δ, 0, ...)) per column
    (snpfrags.rs:483, phase.rs:238-255)."""
    lp, lm = _phase_lp_lm(frags, ct, read_mask, gs)
    lcur = np.where(delta_sign > 0, lp, lm)
    with np.errstate(invalid="ignore", divide="ignore"):
        q = 1.0 - lcur / (lp + lm)
        return -10.0 * np.log10(1.0 - q)


def assign_snp_haplotype_genotype(frags: FragmentMatrix, cands: CandidateSet,
                                  cfg: CallerConfig, ct: CellTables,
                                  apply_downsampling: bool) -> None:
    """snpfrags.rs:378-546. Mutates cands haplotype/genotype/variant_type/
    phase_score/non_selected/single."""
    K, I = frags.p.shape
    if I == 0:
        return
    ds = frags.downsampled if apply_downsampling else np.ones(K, bool)
    base = frags.for_phasing & (frags.num_hete_links >= cfg.min_linkers) & ds
    # two gather variants: vt==1 requires assignment != 0 (snpfrags.rs:417)
    mask_a = base & (frags.assignment != 0)
    mask_b = base
    delta = cands.haplotype.astype(np.float64)
    gs_a = _group_sums(frags, ct, mask_a)
    gs_b = _group_sums(frags, ct, mask_b)
    sm_a, sf_a, sr_a, sa_a, cov_a, h1_a, h2_a = _column_sums(
        frags, ct, mask_a, delta, gs_a)
    sm_b, sf_b, sr_b, sa_b, cov_b, h1_b, h2_b = _column_sums(
        frags, ct, mask_b, delta, gs_b)
    vt1 = cands.variant_type == 1  # gather choice fixed BEFORE updates
    pick = lambda a, b: np.where(vt1, a, b)
    s_match, s_flip, s_refe, s_alte = (pick(sm_a, sm_b), pick(sf_a, sf_b),
                                       pick(sr_a, sr_b), pick(sa_a, sa_b))
    cov = pick(cov_a, cov_b)
    n_h1 = pick(h1_a, h1_b)
    n_h2 = pick(h2_a, h2_b)
    q1, q2, q3, q4 = _snp_qs_np(s_match, s_flip, s_refe, s_alte, cov)
    # phase-score column log-sums for both gather variants (δ-independent)
    lp_a, lm_a = _phase_lp_lm(frags, ct, mask_a, gs_a)
    lp_b, lm_b = _phase_lp_lm(frags, ct, mask_b, gs_b)
    lp = pick(lp_a, lp_b)
    lm = pick(lm_a, lm_b)

    has_cover = (frags.p != 0).any(axis=0) if K else np.zeros(I, bool)
    # vectorised form of the reference's per-SNP loop (snpfrags.rs:401-545);
    # the round-1 Python loop ran 6x per region and went interpreter-bound
    # at 1e4+ candidates per contig
    forp = cands.for_phasing
    cands.non_selected[~forp] = True
    c_single = forp & ~has_cover
    cands.single[c_single] = True
    live = forp & has_cover
    cands.non_selected[live & (cov == 0)] = True
    live &= cov != 0
    # Rust's fold-max semantics (NaN never wins a `>` comparison): iterate
    # "if q > mx: mx = q" so a NaN mx from a zero denominator keeps the
    # reference's all-branches-miss behaviour (falls through to genotype=-1)
    mx = q1.copy()
    for q in (q2, q3, q4):
        upd = q > mx
        mx = np.where(upd, q, mx)
    b1 = live & (q1 == mx)
    b2 = live & ~b1 & (q2 == mx)
    b3 = live & ~b1 & ~b2 & (q3 == mx)
    b4 = live & ~b1 & ~b2 & ~b3
    cands.haplotype[b2] = -cands.haplotype[b2]
    het = b1 | b2
    cands.genotype[het] = 0
    cands.variant_type[het] = 1
    cands.genotype[b3] = 1
    cands.variant_type[b3] = 0
    cands.genotype[b4] = -1
    vt_keep = (cands.variant_type == 2) | (cands.variant_type == 3)
    cands.variant_type[b4 & ~vt_keep] = 2
    cands.non_selected[b3 | b4] = True
    ph_ok = het & (cov > 0) & (n_h1 >= 1) & (n_h2 >= 1)
    lcur = np.where(cands.haplotype > 0, lp, lm)
    with np.errstate(invalid="ignore", divide="ignore"):
        # exact reference expression: -10·log10(1 - (1 - lcur/Σ))
        q = 1.0 - lcur / (lp + lm)
        score = -10.0 * np.log10(1.0 - q)
    cands.phase_score[ph_ok] = score[ph_ok]
    cands.phase_score[het & ~ph_ok] = PHASE_SCORE_SENTINEL


def _phase_lp_lm(frags: FragmentMatrix, ct: CellTables, read_mask: np.ndarray,
                 gs: Optional[np.ndarray] = None):
    """Column sums L(+1), L(-1) for cal_phase_score_log (x = σ·δ, η=0):
    the δ=+1 column of the same σ-group decomposition."""
    K, I = frags.p.shape
    if gs is None:
        gs = _group_sums(frags, ct, read_mask)
    A = gs[:, 0:I]
    B = gs[:, I:2 * I]
    E = gs[:, 2 * I:3 * I]
    lp = A[0] + B[1] + E[2]
    lm = B[0] + A[1] + E[2]
    return lp, lm


def _eval_rescue(frags: FragmentMatrix, cands: CandidateSet,
                 cfg: CallerConfig, ct: CellTables, idx: np.ndarray,
                 min_phase_score: float, apply_downsampling: bool,
                 rng: np.random.Generator, kind: str) -> None:
    """Shared body of eval_rna_edit_var_phase (snpfrags.rs:191-281) and
    eval_low_frac_var_phase (snpfrags.rs:283-376)."""
    K, I = frags.p.shape
    if idx.size == 0 or K == 0:
        return
    ds = frags.downsampled if apply_downsampling else np.ones(K, bool)
    gmask = (frags.for_phasing & (frags.assignment != 0)
             & (frags.num_hete_links >= cfg.min_linkers) & ds)
    gs = _group_sums(frags, ct, gmask)
    C = gs[:, 3 * I:]
    cov = C[5].astype(np.int64)
    n_h1 = C[3].astype(np.int64)
    n_h2 = C[4].astype(np.int64)
    ps1 = _phase_score_cols(frags, ct, gmask, np.ones(I), gs)
    ps2 = _phase_score_cols(frags, ct, gmask, -np.ones(I), gs)
    has_cover = (frags.p != 0).any(axis=0)
    # vectorised classification (per-column inputs were all precomputed
    # above, so the reference's sequential scan only matters for the RNG
    # side effects of rescued columns — handled in idx order below)
    m_nc = ~has_cover[idx]
    m_vt = ~m_nc & (cands.variant_type[idx] != 1)
    m_low = (~m_nc & ~m_vt
             & ((cov[idx] == 0) | (n_h1[idx] < 2) | (n_h2[idx] < 2)))
    m_eval = ~m_nc & ~m_vt & ~m_low
    cands.single[idx[m_nc | m_low]] = True
    cands.non_selected[idx[m_vt]] = True
    cands.single[idx[m_eval]] = False
    best = np.maximum(ps1[idx], ps2[idx])
    m_resc = m_eval & (best >= min_phase_score)
    m_fail = m_eval & ~m_resc
    # failed: parked for the next pass (snpfrags.rs:276-281, 370-376)
    cands.non_selected[idx[m_fail]] = True
    if kind == "edit":
        cands.rna_editing[idx[m_fail]] = True
    else:
        cands.cand_somatic[idx[m_fail]] = True
        cands.for_phasing[idx[m_fail]] = False
    # rescued: in-phase at the relaxed threshold (snpfrags.rs:250-274,
    # 342-368). Sequential in idx order: the per-covering-read rng.random()
    # draws are order-dependent and later columns see earlier haplotag writes.
    ri = idx[m_resc]
    cands.non_selected[ri] = False
    cands.rna_editing[ri] = False
    if kind == "somatic":
        cands.cand_somatic[ri] = False
    cands.for_phasing[ri] = True
    cands.haplotype[ri] = np.where(ps1[ri] >= ps2[ri], 1, -1)
    cands.genotype[ri] = 0
    cands.variant_type[ri] = 1
    cands.phase_score[ri] = best[m_resc]
    for i in ri.tolist():
        covers = np.nonzero(frags.p[:, i] != 0)[0]
        for k in covers:
            frags.for_phasing[k] = True
            if frags.haplotag[k] == 0 or frags.assignment[k] == 0:
                frags.haplotag[k] = -1 if rng.random() < 0.5 else 1


def eval_rna_edit_var_phase(frags, cands, cfg, ct, min_phase_score,
                            apply_downsampling, rng) -> None:
    _eval_rescue(frags, cands, cfg, ct, np.nonzero(cands.rna_editing)[0],
                 min_phase_score, apply_downsampling, rng, "edit")


def eval_low_frac_var_phase(frags, cands, cfg, ct, min_phase_score,
                            apply_downsampling, rng) -> None:
    _eval_rescue(frags, cands, cfg, ct, np.nonzero(cands.cand_somatic)[0],
                 min_phase_score, apply_downsampling, rng, "somatic")


def assign_phase_set(frags: FragmentMatrix, cands: CandidateSet,
                     min_phase_score: float) -> Dict[str, int]:
    """snpfrags.rs:628-733: consistency graph over confident phased hets,
    connected components → PS ids; reads inherit the PS of their edges
    (first-wins). Mutates cands.phase_set; returns read_id → PS."""
    K, I = frags.p.shape
    node_mask = ((cands.genotype == 0) & (cands.variant_type == 1)
                 & ~cands.dense & ~cands.rna_editing
                 & (cands.phase_score >= min_phase_score))
    nodes = np.nonzero(node_mask)[0]
    phase_sets: Dict[str, int] = {}
    if nodes.size == 0:
        return phase_sets
    parent = {int(i): int(i) for i in nodes}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    # edges: per active frag, consistent node pairs (snpfrags.rs:674-693).
    # Vectorised: flatten active reads' node cells, generate the unordered
    # pairs grouped by per-read cell count, filter by hap-product consistency;
    # unions run over the (small) set of unique consistent pairs. A read's PS
    # comes from its lexicographically smallest consistent pair — identical
    # to the loop form's sorted-edge, first-wins traversal.
    hap = cands.haplotype.astype(np.int64)
    act_mask = frags.for_phasing & (frags.assignment != 0)
    active = np.nonzero(act_mask)[0]
    # node cells of active reads straight from the CSR view (read-major,
    # ascending column within a read — the same order np.nonzero gives on
    # the dense [active, I] mask, so read_key/first-wins ties are identical)
    off, ci, cpv, _cq = frags.flat_cells()
    read_of_cell = np.repeat(np.arange(K, dtype=np.int64),
                             np.diff(off)) if K else np.zeros(0, np.int64)
    keep = act_mask[read_of_cell] & node_mask[ci]
    row_of_read = np.full(K, -1, np.int64)
    row_of_read[active] = np.arange(active.size)
    kk = row_of_read[read_of_cell[keep]]
    ii = ci[keep].astype(np.int64)
    pv = cpv[keep].astype(np.int64)
    counts = np.bincount(kk, minlength=active.size).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    read_key = np.full(len(active), np.iinfo(np.int64).max, np.int64)
    self_rows = np.nonzero(counts == 1)[0]
    read_key[self_rows] = ii[offs[self_rows]] * np.int64(I) + ii[offs[self_rows]]
    pair_chunks = []
    from .fragments import _triu_cached
    for m in np.unique(counts):
        if m < 2:
            continue
        rows = np.nonzero(counts == m)[0]
        idx = offs[rows][:, None] + np.arange(m)[None, :]     # [R, m]
        C = ii[idx].astype(np.int64)
        Pm = pv[idx]
        ia, ib = _triu_cached(int(m))
        ci, cj = C[:, ia], C[:, ib]                           # i < j per read
        cons = hap[ci] * hap[cj] == Pm[:, ia] * Pm[:, ib]
        keys = np.where(cons, ci * I + cj, np.iinfo(np.int64).max)
        np.minimum.at(read_key, np.repeat(rows, ia.size), keys.ravel())
        pair_chunks.append(np.unique(keys[cons]))
    if pair_chunks:
        for key in np.unique(np.concatenate(pair_chunks)).tolist():
            union(key // I, key % I)
    # components → PS id = 1-based pos of smallest-position member
    comp_nodes: Dict[int, List[int]] = {}
    for i in nodes.tolist():
        comp_nodes.setdefault(find(int(i)), []).append(int(i))
    node_ps = {}
    for root, members in sorted(comp_nodes.items()):
        ps_id = int(cands.pos[min(members)]) + 1
        for i in members:
            cands.phase_set[i] = ps_id
            node_ps[i] = ps_id
    # reads in (smallest consistent pair, read index) order, first-wins
    tagged = np.nonzero(read_key != np.iinfo(np.int64).max)[0]
    for r in tagged[np.argsort(read_key[tagged], kind="stable")].tolist():
        phase_sets.setdefault(frags.qnames[int(active[r])],
                              node_ps[int(read_key[r]) // I])
    return phase_sets
