"""Phasing optimizer: synchronous coordinate ascent + enumeration (torch).

Port of the per-region path of ``longcallr_tpu/phasing/optimize.py``
(``longcallR/src/phase.rs:810-1395``: cross_optimize, phase,
cross_optimize_by_block). The reference's per-read/per-SNP argmax loops are
synchronous (all reads update from the current SNP state, then all SNPs
from the new read state), so each half-step is one batched tensor call.
The ≤21-iteration ascent is a Python loop that reads its continue flag once
per trip; a batch of ascents (the enumeration path's configs) runs as one
loop in which each member freezes when its own flag drops — the semantics
of the JAX package's vmapped ``while_loop``.

Execution modes (the JAX package's knobs): LONGCALLR_FAST_KERNELS=0
selects the reference-form ascent (the specification); the default
matvec-form ascent runs in split mode — f32-split Dp through the hand
kernels of ``cuda_kernels`` — on CUDA and in f64 on the CPU
(LONGCALLR_F32_KERNELS=0/1 forces either). Split-mode regions whose final
decision margins lie inside the split error bound are recomputed in f64 on
the same device (``N_F64_RERUNS`` counts them).

The host passes (LD blocks, BFS haplotype init, enumeration order, the
exact block-flip pass) are copied from the JAX package unchanged; the
perturbation randoms come from ``rng.py`` (bit-identical to the JAX
package's ``jax.random`` draws).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from ..config import CallerConfig

from ..ops.candidates import CandidateSet
from . import kernels_fast as KF
from . import rng as R
from .fragments import FragmentMatrix
from .kernels import (TIE_TOL, CellTables, CompactCells, as_tables, f64,
                      make_cell_tables_np, overall_probability, read_logliks,
                      sigma_q, snp_qs, snp_sums)


class PhaseState(NamedTuple):
    sigma: torch.Tensor   # [..., K] f64 in {-1,0,+1}
    delta: torch.Tensor   # [..., I] f64 in {-1,+1} (0 = unassigned)
    eta: torch.Tensor     # [..., I] f64 in {-1,0,+1}

    @classmethod
    def from_numpy(cls, sigma, delta, eta,
                   device=torch.device("cpu")) -> "PhaseState":
        t = lambda a: torch.tensor(np.asarray(a, np.float64), device=device)
        return cls(t(sigma), t(delta), t(eta))

    def to_numpy(self) -> "PhaseState":
        n = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
        return PhaseState(n(self.sigma), n(self.delta), n(self.eta))


# execution-mode switches (the JAX package's environment knobs)
USE_FAST_KERNELS = os.environ.get("LONGCALLR_FAST_KERNELS", "1") == "1"
_F32_ENV = os.environ.get("LONGCALLR_F32_KERNELS")
USE_F32_KERNELS: Optional[bool] = (None if _F32_ENV is None
                                   else _F32_ENV == "1")
# f32 safety net bound (LONGCALLR_F32_SAFETY=0 disables)
_SAFETY_ENV = os.environ.get("LONGCALLR_F32_SAFETY", "")
F32_SAFETY_TOL: float = (float(_SAFETY_ENV) if _SAFETY_ENV else 1e-3)

# process totals: split-mode regions whose split result was kept, and
# split-mode regions the safety net recomputed in f64
N_SPLIT_KEPT = 0
N_F64_RERUNS = 0
_count_lock = threading.Lock()


def _note(kept: bool) -> None:
    global N_SPLIT_KEPT, N_F64_RERUNS
    with _count_lock:
        if kept:
            N_SPLIT_KEPT += 1
        else:
            N_F64_RERUNS += 1


def split_mode(device: torch.device) -> bool:
    """Split (f32 hi/lo Dp through the hand kernels) or f64: on for CUDA,
    off on the CPU, unless LONGCALLR_F32_KERNELS forces it."""
    if USE_F32_KERNELS is not None:
        return USE_F32_KERNELS
    return torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# ascent loops (phase.rs:810-976)
# ---------------------------------------------------------------------------

def _select(mask, new: PhaseState, old: PhaseState) -> PhaseState:
    """Per-member select of batched states (mask [B] or scalar)."""
    def sel(a, b):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        return torch.where(m, a, b)
    return PhaseState(sel(new.sigma, old.sigma), sel(new.delta, old.delta),
                      sel(new.eta, old.eta))


def _ascend(st: PhaseState, sigma_step, snp_step) -> PhaseState:
    """≤21 synchronous half-step pairs; each member of a batch stops when
    its own continue flag (any σ flip or any δ/η change) drops."""
    active = None
    for _ in range(21):
        new_sigma, s_inc = sigma_step(st)
        st1 = st._replace(sigma=new_sigma)
        new_delta, new_eta, d_inc = snp_step(st1)
        st1 = st1._replace(delta=new_delta, eta=new_eta)
        go = s_inc | d_inc
        if active is None:
            st, active = st1, go
        else:
            st, active = _select(active, st1, st), active & go
        if not bool(active.any()):
            break
    return st


def _snp_decision(q1, q2, q3, q4, cov, st: PhaseState, site_mask, conserved,
                  with_genotype: bool, keep_conserved: bool):
    """(δ, η) argmax with the reference's tie rules, TIE_TOL-quantized
    (phase.rs:871-965). Returns (delta, eta, changed)."""
    upd = site_mask & (cov > 0)
    if keep_conserved:
        upd = upd & ~conserved
    if with_genotype:
        mx = torch.maximum(torch.maximum(q1, q2), torch.maximum(q3, q4))
        # tie order q1 > q2 > q3 > q4 (phase.rs:909-921)
        pick = torch.where(q1 >= mx - TIE_TOL, 0,
                           torch.where(q2 >= mx - TIE_TOL, 1,
                                       torch.where(q3 >= mx - TIE_TOL, 2, 3)))
    else:
        het = st.eta == 0
        pick = torch.where(het, torch.where(q2 > q1 + TIE_TOL, 1, 0),
                           torch.where(q4 > q3 + TIE_TOL, 3, 2))
    new_delta = torch.where(upd & (pick == 1), -st.delta, st.delta)
    new_eta = torch.where(
        upd, torch.where(pick <= 1, 0.0, torch.where(pick == 2, 1.0, -1.0)),
        st.eta)
    changed = ((new_delta != st.delta) | (new_eta != st.eta)).any(dim=-1)
    return new_delta, new_eta, changed


def _cross_optimize_loop(ct, st: PhaseState, read_base, site_mask,
                         conserved, with_genotype: bool,
                         keep_conserved: bool):
    """Reference-form ascent (the specification path)."""
    ct = as_tables(ct)

    def sigma_step(st):
        lp, lm, ncell = read_logliks(ct, st.delta, st.eta, site_mask)
        upd = read_base & (st.sigma != 0) & (ncell > 0)
        q, qn = sigma_q(lp, lm, st.sigma)
        flip = upd & (qn > q + TIE_TOL)
        return torch.where(flip, -st.sigma, st.sigma), flip.any(dim=-1)

    def snp_step(st):
        read_mask = read_base & (st.sigma != 0)
        sums = snp_sums(ct, st.sigma, st.delta, read_mask, site_mask)
        return _snp_decision(*snp_qs(*sums), sums[4], st, site_mask,
                             conserved, with_genotype, keep_conserved)

    st = _ascend(st, sigma_step, snp_step)
    read_mask = read_base & (st.sigma != 0)
    prob = overall_probability(ct, st.sigma, st.delta, st.eta, read_mask,
                               site_mask)
    return st, prob


def _fast_tables_for(ct, read_base, sigma, site_mask, split: bool):
    """Tables for an ascent whose entry state is σ: the active-read set
    read_base & (σ≠0) is invariant under the ascent and the perturbation
    schedule (σ only flips sign), so a schedule builds them once. A batch
    of entry states must share that set."""
    rm0 = read_base & (sigma != 0)
    if rm0.dim() > 1:
        if not bool((rm0 == rm0[:1]).all()):
            raise ValueError("batched ascents must share one active-read set")
        rm0 = rm0[0]
    if split:
        if isinstance(ct, CompactCells):
            return KF.fast_tables32_from_compact(ct, rm0, site_mask)
        return KF.make_fast_tables32(as_tables(ct), rm0, site_mask)
    return KF.make_fast_tables(as_tables(ct), rm0, site_mask)


def _cross_optimize_fast_loop(ct, st: PhaseState, read_base, site_mask,
                              conserved, with_genotype: bool,
                              keep_conserved: bool, split: bool, ft=None):
    """Matvec-form ascent (kernels_fast): the reference's argmax/tie rules,
    two matvecs per iteration. ``ft``: prebuilt tables (their active-read
    mask must equal read_base & (st.sigma != 0))."""
    rm0 = read_base & (st.sigma != 0)
    if ft is None:
        ft = _fast_tables_for(ct, read_base, st.sigma, site_mask, split)
    if split:
        read_ll, snp_s, objective = (KF.fast_read_logliks32,
                                     KF.fast_snp_sums32,
                                     KF.fast_overall_probability32)
    else:
        read_ll, snp_s, objective = (KF.fast_read_logliks, KF.fast_snp_sums,
                                     KF.fast_overall_probability)

    def sigma_step(st):
        lp, lm, ncell = read_ll(ft, st.delta, st.eta)
        upd = rm0 & (ncell > 0)
        q, qn = sigma_q(lp, lm, st.sigma)
        flip = upd & (qn > q + TIE_TOL)
        return torch.where(flip, -st.sigma, st.sigma), flip.any(dim=-1)

    def snp_step(st):
        sums = snp_s(ft, st.sigma, st.delta)
        return _snp_decision(*snp_qs(*sums), sums[4], st, site_mask,
                             conserved, with_genotype, keep_conserved)

    st = _ascend(st, sigma_step, snp_step)
    return st, objective(ft, st.sigma, st.delta, st.eta)


def cross_optimize(ct, st: PhaseState, read_base, site_mask, conserved,
                   with_genotype: bool, keep_conserved: bool,
                   split: bool = False, ft=None):
    """Alternating coordinate ascent, ≤21 iterations (phase.rs:810-976).
    Returns (final state, overall log10 probability)."""
    if USE_FAST_KERNELS:
        return _cross_optimize_fast_loop(ct, st, read_base, site_mask,
                                         conserved, with_genotype,
                                         keep_conserved, split, ft)
    return _cross_optimize_loop(ct, st, read_base, site_mask, conserved,
                                with_genotype, keep_conserved)


# ---------------------------------------------------------------------------
# safety-net margin, objective, perturbation schedule
# ---------------------------------------------------------------------------

def f64_decision_margin_fast(p8, q8, sigma, delta, eta, read_base,
                             site_mask) -> torch.Tensor:
    """Smallest decision gap at a final state, in exact f64 (matvec form):
    per read |q − q_flip|, per SNP the top-2 gap among the four (δ, η)
    candidates. A gap below F32_SAFETY_TOL means a split-mode run may have
    taken another branch than f64 would."""
    ct = as_tables(CompactCells(p8, q8))
    rm0 = read_base & (sigma != 0)
    ft = KF.make_fast_tables(ct, rm0, site_mask)
    lp, lm, ncell = KF.fast_read_logliks(ft, delta, eta)
    upd = rm0 & (ncell > 0)
    q, qn = sigma_q(lp, lm, sigma)
    inf = torch.full((), float("inf"), dtype=f64, device=sigma.device)
    sig_gap = torch.where(upd, (q - qn).abs(), inf).min()
    sums = KF.fast_snp_sums(ft, sigma, delta)
    qs = torch.stack(snp_qs(*sums))                       # [4, I]
    upds = site_mask & (sums[4] > 0)
    mx = qs.max(dim=0).values
    am = qs.argmax(dim=0)
    ar4 = torch.arange(4, device=qs.device)[:, None]
    second = torch.where(ar4 == am[None, :], -inf, qs).max(dim=0).values
    snp_gap = torch.where(upds, mx - second, inf).min()
    return torch.minimum(sig_gap, snp_gap)


def _overall_probability(ct, sigma, delta, eta, read_base, site_mask,
                         split: bool) -> torch.Tensor:
    """cal_overall_probability; in split mode via the split tables (the
    scale of the split-mode ascent objectives it is compared against)."""
    if USE_FAST_KERNELS and split and isinstance(ct, CompactCells):
        ft = _fast_tables_for(ct, read_base, sigma, site_mask, True)
        return KF.fast_overall_probability32(ft, sigma, delta, eta)
    ct = as_tables(ct)
    rm = read_base & (sigma != 0)
    return overall_probability(ct, sigma, delta, eta, rm, site_mask)


def _keep_best(b_st: PhaseState, b_p, st_new: PhaseState, p_new):
    """Tie-quantized keep-best on the device (no host sync)."""
    better = p_new > b_p + TIE_TOL
    return _select(better, st_new, b_st), torch.where(better, p_new, b_p)


def perturbation_phase(ct, st: PhaseState, best_st: PhaseState, best_prob,
                       read_base, site_mask, conserved, n_rounds: int, key,
                       split: bool = False) -> Tuple[PhaseState, torch.Tensor]:
    """The perturbation schedule (phase.rs:1198-1233): n_rounds iterations
    of {10% SNP resets → ascent → keep-best → 10% read flips → ascent →
    keep-best}. ``key`` is a threefry key (rng.prng_key); the round
    randoms are drawn at the padded sizes, as in the JAX package."""
    K = st.sigma.shape[0]
    I = st.delta.shape[0]
    dev = st.sigma.device
    if USE_FAST_KERNELS:
        ft = _fast_tables_for(ct, read_base, st.sigma, site_mask, split)
        ascend = lambda st0: _cross_optimize_fast_loop(
            None, st0, read_base, site_mask, conserved, False, False, split,
            ft=ft)
    else:
        ct = as_tables(ct)
        ascend = lambda st0: _cross_optimize_loop(
            ct, st0, read_base, site_mask, conserved, False, False)
    rg_np, fl_np = R.predraw_rounds(key, K, I)
    rg_all = torch.as_tensor(rg_np, device=dev)
    fl_all = torch.as_tensor(fl_np, device=dev)
    b_st = best_st
    b_p = torch.as_tensor(best_prob, dtype=f64, device=dev)
    for t in range(int(n_rounds)):
        lowv = 1.0 if t % 2 == 1 else -1.0
        rg = rg_all[t]
        delta = torch.where(rg < 0.1, lowv,
                            torch.where(rg >= 0.9, -lowv, b_st.delta))
        st1, prob1 = ascend(b_st._replace(delta=delta))
        b_st, b_p = _keep_best(b_st, b_p, st1, prob1)
        fl = (fl_all[t] < 0.1) & read_base & (b_st.sigma != 0)
        sigma = torch.where(fl, -b_st.sigma, b_st.sigma)
        st2, prob2 = ascend(b_st._replace(sigma=sigma))
        b_st, b_p = _keep_best(b_st, b_p, st2, prob2)
    return b_st, b_p


def enumeration_order(n: int) -> np.ndarray:
    """All 2^n haplotype configs in the reference's enumeration order
    (phase.rs:1099-1106): start at all-ones; for each snp, append copies of
    every existing config with that snp flipped."""
    configs = [np.ones(n, dtype=np.int8)]
    for ti in range(n):
        for tj in range(len(configs)):
            c = configs[tj].copy()
            c[ti] = -c[ti]
            configs.append(c)
    assert len(configs) == 2 ** n
    return np.stack(configs) if n > 0 else np.ones((1, 0), dtype=np.int8)


# ---------------------------------------------------------------------------
# LD blocks (host): divide_snps_into_blocks (candidate.rs:615-747)
# ---------------------------------------------------------------------------

@dataclass
class LDInfo:
    pair_ld: Dict[Tuple[int, int], Tuple[float, int]]  # (score f32, weight)
    blocks: List[List[int]]          # each ≥1 snp, sorted; list sorted by min
    block_id: np.ndarray             # [I] int32, -1 if unblocked
    adj: Dict[int, List[int]]        # ld_graph adjacency (post weight filter)


def compute_ld_blocks(cands: CandidateSet, frags: FragmentMatrix,
                      ld_weight_threshold: int = 1) -> LDInfo:
    pair_ld: Dict[Tuple[int, int], Tuple[float, int]] = {}
    edges: Dict[Tuple[int, int], int] = {}
    nodes: Set[int] = set()
    ref_ok = ((cands.alleles[:, 0] == cands.ref_base)
              | (cands.alleles[:, 1] == cands.ref_base))
    # allele_freqs of (ref, alt) nonzero requirement (candidate.rs:670-676)
    ref_is_a1 = cands.alleles[:, 0] == cands.ref_base
    ref_frac = np.where(ref_is_a1, cands.allele_freqs[:, 0], cands.allele_freqs[:, 1])
    alt_frac = np.where(ref_is_a1, cands.allele_freqs[:, 1], cands.allele_freqs[:, 0])
    for (i, j), tbl in frags.ld_counts.items():
        if not (cands.for_phasing[i] and cands.for_phasing[j]):
            continue
        if not (ref_ok[i] and ref_ok[j]):
            continue
        if ref_frac[i] == 0 or alt_frac[i] == 0 or ref_frac[j] == 0 or alt_frac[j] == 0:
            continue
        c_rr, c_ra, c_ar, c_aa = int(tbl[0, 0]), int(tbl[0, 1]), int(tbl[1, 0]), int(tbl[1, 1])
        same = c_rr + c_aa
        opp = c_ra + c_ar
        c1, c2 = min(same, opp), max(same, opp)
        score = np.float32(c1) / np.float32(c2)  # NaN when c2 == 0
        if same > opp:
            sw = (float(score), c2)
        else:
            sw = (float(-score), -c2)
        pair_ld[(i, j)] = sw
        if score == 0.0:  # perfect LD (c1==0, c2>0); NaN fails
            edges[(i, j)] = sw[1]
            nodes.add(i)
            nodes.add(j)
    # weight filter (|w| < threshold dropped), nodes retained
    adj: Dict[int, List[int]] = {n: [] for n in nodes}
    for (i, j), w in edges.items():
        if abs(w) >= ld_weight_threshold:
            adj[i].append(j)
            adj[j].append(i)
    # connected components (deterministic: ordered by min node)
    block_id = np.full(cands.n, -1, dtype=np.int32)
    blocks: List[List[int]] = []
    seen: Set[int] = set()
    for start in sorted(nodes):
        if start in seen:
            continue
        comp = []
        stack = [start]
        seen.add(start)
        while stack:
            u = stack.pop()
            comp.append(u)
            for v in adj[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        comp.sort()
        blocks.append(comp)
    for bid, comp in enumerate(blocks):
        for u in comp:
            block_id[u] = bid
    for n in adj:
        adj[n].sort()
    return LDInfo(pair_ld=pair_ld, blocks=blocks, block_id=block_id, adj=adj)


def init_haplotypes_ld(cands: CandidateSet, ld: LDInfo,
                       rng: np.random.Generator,
                       ld_weight_threshold: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """init_haplotypes_LD2 (phase.rs:609-671): random ±1 everywhere, then
    BFS-consistent haplotypes inside each perfect-LD block. Returns
    (delta0[I] int8, conserved[I] bool)."""
    n = cands.n
    delta = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int8)
    conserved = np.zeros(n, dtype=bool)
    for comp in ld.blocks:
        if len(comp) < 2:
            continue
        root = comp[0]
        delta[root] = 1
        visited = [root]
        vset = {root}
        queue = [root]
        order = []
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in ld.adj.get(u, []):
                if v not in vset:
                    vset.add(v)
                    queue.append(v)
        for nx in order:
            if nx == root:
                continue
            for vi in visited:
                a, b = (vi, nx) if vi < nx else (nx, vi)
                sw = ld.pair_ld.get((a, b))
                if sw is None or sw[0] != 0.0:
                    continue
                w = sw[1]
                if w >= ld_weight_threshold:
                    delta[nx] = delta[vi]
                    break
                if w <= -ld_weight_threshold:
                    delta[nx] = -delta[vi]
                    break
            visited.append(nx)
        for u in comp:
            conserved[u] = True
    return delta, conserved


# ---------------------------------------------------------------------------
# Block flip pass: cross_optimize_by_block (phase.rs:1298-1394)
# ---------------------------------------------------------------------------

def _block_flip_fast(p8, q8, sigma, delta, eta, read_base, site_mask, bid):
    """Single-region device block flip over the split tables (split mode
    only — kernels_fast.fast_block_flip32)."""
    ft = _fast_tables_for(CompactCells(p8, q8), read_base, sigma, site_mask,
                          True)
    return KF.fast_block_flip32(ft, p8, sigma, delta, eta, site_mask, bid)


def block_flip_pass(ct_np: CellTables, st: PhaseState, read_base: np.ndarray,
                    site_mask: np.ndarray, exists: np.ndarray,
                    ld: LDInfo) -> PhaseState:
    """For every LD block: flip the whole block (and reads fully contained in
    it) if that raises the block objective. All decisions are computed
    against the current state, then applied together. Host numpy in, host
    numpy out."""
    ct = ct_np
    if not ld.blocks:
        return st
    sigma = np.asarray(st.sigma)
    delta = np.asarray(st.delta)
    eta = np.asarray(st.eta)
    K, I = exists.shape
    n_elems = exists.sum(axis=1)
    read_mask = read_base & (sigma != 0)
    pj = np.asarray(ct.p)
    l1m = np.asarray(ct.l1m)
    lerr = np.asarray(ct.lerr)
    m0 = site_mask[None, :] & exists & read_mask[:, None]
    x0 = sigma[:, None] * delta[None, :]
    s_match = np.where(m0, np.where(pj == x0, l1m, lerr), 0.0).sum(axis=0)
    s_flip = np.where(m0, np.where(pj == -x0, l1m, lerr), 0.0).sum(axis=0)
    s_refe = np.where(m0, np.where(pj == 1.0, l1m, lerr), 0.0).sum(axis=0)
    s_alte = np.where(m0, np.where(pj == -1.0, l1m, lerr), 0.0).sum(axis=0)
    cov = m0.sum(axis=0)
    # flip variant: sigma' = -sigma for reads fully inside the snp's block
    block_id = ld.block_id
    if block_id.shape[0] < I:
        block_id = np.pad(block_id, (0, I - block_id.shape[0]),
                          constant_values=-1)
    full_in = np.zeros((K,), dtype=np.int32) - 1  # block fully containing read
    for bid, comp in enumerate(ld.blocks):
        cols = np.asarray(comp)
        n_in = exists[:, cols].sum(axis=1)
        full = (n_in == n_elems) & (n_elems > 0)
        full_in[full] = bid
    flip_factor = np.ones((K, I), dtype=np.int8)
    blocked_cols = block_id >= 0
    ff_rows = full_in[:, None] == block_id[None, :]
    flip_factor[ff_rows & blocked_cols[None, :]] = -1
    # S'_match-flip: x = sigma*flip_factor*(-delta) per cell
    m = m0
    x_new = sigma[:, None] * flip_factor * (-delta[None, :])
    s_match_new = np.where(m, np.where(pj == x_new, l1m, lerr), 0.0).sum(axis=0)
    s_flip_new = np.where(m, np.where(pj == -x_new, l1m, lerr), 0.0).sum(axis=0)
    from .kernels import (PRIOR_HOMREF_LOG, PRIOR_HOMVAR_LOG, _LOG10_HALF,
                          _PRIOR_HET_BASE)
    ph = np.where(cov == 0, _PRIOR_HET_BASE,
                  _PRIOR_HET_BASE - cov * _LOG10_HALF)
    p_homref = PRIOR_HOMREF_LOG
    p_homvar = PRIOR_HOMVAR_LOG

    def q_of(sm, sf, e):
        n1 = np.where(e == 0, sm + ph, np.where(e == 1, s_refe + p_homref,
                                                s_alte + p_homvar))
        d = (s_alte + p_homvar) + (sm + ph) + (s_refe + p_homref) + (sf + ph)
        return 1.0 - n1 / d

    q_cur = q_of(s_match, s_flip, eta)
    q_new = q_of(s_match_new, s_flip_new, eta)
    new_delta = delta.copy()
    new_sigma = sigma.copy()
    phase_site_cells = exists & site_mask[None, :]
    for bid, comp in enumerate(ld.blocks):
        cols = np.asarray(comp)
        if q_new[cols].sum() > q_cur[cols].sum() + TIE_TOL:
            new_delta[cols] = -delta[cols]
            covers = phase_site_cells[:, cols].any(axis=1)
            flip_reads = (full_in == bid) & covers & read_mask
            new_sigma[flip_reads] = -sigma[flip_reads]
    return PhaseState(new_sigma.astype(np.float64),
                      new_delta.astype(np.float64), np.asarray(st.eta))


# ---------------------------------------------------------------------------
# phase(): top-level per-region optimization (phase.rs:1087-1296)
# ---------------------------------------------------------------------------

def init_genotype(cands: CandidateSet) -> np.ndarray:
    """variant_type → eta (phase.rs:682-691)."""
    vt = cands.variant_type
    return np.where(vt == 0, 1, np.where(vt == 1, 0, -1)).astype(np.int8)


def _bucket(n: int, lo: int = 8) -> int:
    """Round up to a power of two. The padded sizes also fix the shapes of
    the random draws, so they must match the JAX package's."""
    b = lo
    while b < n:
        b <<= 1
    return b


def phase_region(frags: FragmentMatrix, cands: CandidateSet,
                 cfg: CallerConfig, seed: int,
                 apply_downsampling: bool = False,
                 device: torch.device = torch.device("cpu")) -> PhaseState:
    """Run the full phase() optimization for one region on ``device``.
    Returns the final state as host numpy, sliced back to true sizes."""
    K0, I0 = frags.p.shape
    if I0 == 0:
        return PhaseState(np.zeros(K0), np.zeros(0), np.zeros(0))
    st = _phase_region_padded(frags, cands, cfg, seed, apply_downsampling,
                              torch.device(device)).to_numpy()
    return PhaseState(st.sigma[:K0], st.delta[:I0], st.eta[:I0])


def _phase_region_padded(frags: FragmentMatrix, cands: CandidateSet,
                         cfg: CallerConfig, seed: int,
                         apply_downsampling: bool,
                         device: torch.device) -> PhaseState:
    K0, I0 = frags.p.shape
    K, I_pad = _bucket(max(1, K0)), _bucket(max(1, I0))
    return _phase_region_padded_impl(frags, cands, cfg, seed,
                                     apply_downsampling, K0, I0, K, I_pad,
                                     device, split_mode(device))


def _phase_region_padded_impl(frags, cands, cfg, seed, apply_downsampling,
                              K0, I0, K, I_pad, device,
                              split: bool) -> PhaseState:
    I = I0  # logical candidate count (enumeration path keys off this)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, seed & 0x7FFFFFFF]))
    padKI = lambda a: np.pad(a, ((0, K - K0), (0, I_pad - I0)))
    padK = lambda a, v=0: np.pad(a, (0, K - K0), constant_values=v)
    padI = lambda a, v=0: np.pad(a, (0, I_pad - I0), constant_values=v)
    on_dev = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    # compact transfer form: 2 bytes/cell; the f64 emission tables expand on
    # the device where needed
    p_pad = padKI(frags.p)
    q_pad = padKI(frags.baseq).astype(np.uint8)
    ct = CompactCells.from_numpy(p_pad, q_pad, device)
    site_mask_np = padI(cands.for_phasing)
    site_mask = on_dev(site_mask_np)
    ds = frags.downsampled if apply_downsampling else np.ones(K0, bool)
    read_base_np = padK(frags.for_phasing & ds)
    read_base = on_dev(read_base_np)
    eta0 = padI(init_genotype(cands), 1)
    net = USE_FAST_KERNELS and split and F32_SAFETY_TOL > 0

    def rerun_f64() -> PhaseState:
        _note(kept=False)
        return _phase_region_padded_impl(frags, cands, cfg, seed,
                                         apply_downsampling, K0, I0, K,
                                         I_pad, device, False)

    def margin_of(st: PhaseState) -> float:
        return float(f64_decision_margin_fast(ct.p, ct.q, st.sigma, st.delta,
                                              st.eta, read_base, site_mask))

    ld = compute_ld_blocks(cands, frags)

    if I <= cfg.max_enum_snps:
        # enumeration path (phase.rs:1097-1122)
        configs = enumeration_order(I).astype(np.float64)          # [C,I0]
        configs = np.pad(configs, ((0, 0), (0, I_pad - I)), constant_values=1.0)
        C = configs.shape[0]
        sig0 = np.where(rng.random((C, K)) < 0.5, -1.0, 1.0)
        sig0 = np.where(read_base_np[None, :], sig0, 0.0)
        cons = torch.zeros(I_pad, dtype=torch.bool, device=device)
        eta0_t = on_dev(eta0.astype(np.float64))
        # every config's active-read set read_base & σ≠0 is read_base itself:
        # one set of ascent tables serves all configs
        if not ((sig0 != 0) == read_base_np[None, :]).all():
            raise RuntimeError("enumeration configs do not share the "
                               "active-read set read_base")
        ft = (_fast_tables_for(ct, read_base, on_dev(sig0[0]), site_mask,
                               split) if USE_FAST_KERNELS else None)
        # chunk configs to bound peak memory (C·K·I intermediates)
        chunk = max(1, int(2 ** 24 // max(1, K * I_pad)))
        chunk = min(C, 1 << (chunk.bit_length() - 1))
        best_prob = -np.inf
        best_st = None
        best_idx = -1
        all_probs: List[np.ndarray] = []
        for c0 in range(0, C, chunk):
            sg = on_dev(sig0[c0:c0 + chunk])
            st0 = PhaseState(sg, on_dev(configs[c0:c0 + chunk]),
                             eta0_t.expand(sg.shape[0], I_pad).clone())
            sts, probs = cross_optimize(ct, st0, read_base, site_mask, cons,
                                        with_genotype=True,
                                        keep_conserved=False, split=split,
                                        ft=ft)
            probs = probs.cpu().numpy()
            all_probs.append(probs)
            # sequential keep-best with the tie-quantized rule: first in
            # enumeration order wins structural ties
            sel = -1
            for j in range(len(probs)):
                if probs[j] > best_prob + TIE_TOL:
                    best_prob = float(probs[j])
                    sel = j
            if sel >= 0:
                best_idx = c0 + sel
                best_st = PhaseState(*(a[sel] for a in sts))
        if net:
            # safety net, enumeration leg: the winner's f64 margins AND the
            # gap to every other config's objective (see the JAX package)
            pv = np.concatenate(all_probs)
            others = np.delete(pv, best_idx)
            cfg_gap = (best_prob - float(others.max())
                       if others.size else np.inf)
            # forced split mode has no exact rerun
            if (not USE_F32_KERNELS
                    and min(margin_of(best_st), cfg_gap) < F32_SAFETY_TOL):
                return rerun_f64()
        if split:
            _note(kept=True)
        return best_st

    # iterative path (phase.rs:1123-1294)
    delta0, conserved_np = init_haplotypes_ld(cands, ld, rng)
    delta0 = np.pad(delta0, (0, I_pad - I), constant_values=1)
    conserved_np = np.pad(conserved_np, (0, I_pad - I))
    conserved = on_dev(conserved_np)
    sigma0 = np.where(rng.random(K) < 0.5, -1.0, 1.0)
    sigma0 = np.where(read_base_np, sigma0, 0.0)
    st = PhaseState.from_numpy(sigma0, delta0, eta0, device)

    best_prob = -np.inf
    best_st = st

    def consider(st, prob):
        nonlocal best_prob, best_st
        p = float(prob)
        if p > best_prob + TIE_TOL:   # tie-quantized keep-best
            best_prob = p
            best_st = st

    st, prob = cross_optimize(ct, st, read_base, site_mask, conserved,
                              with_genotype=False, keep_conserved=True,
                              split=split)
    consider(st, prob)
    st = best_st

    # block flip: in split mode on the device over the split tables; a
    # region whose smallest per-block margin is inside the f32 envelope
    # takes the exact host pass
    st2 = None
    if USE_FAST_KERNELS and split:
        bid_pad = np.full(I_pad, -1, np.int32)
        bid_pad[:ld.block_id.shape[0]] = ld.block_id
        sg2, dl2, mg = _block_flip_fast(ct.p, ct.q, st.sigma, st.delta,
                                        st.eta, read_base, site_mask,
                                        on_dev(bid_pad))
        if float(mg) >= KF.F32_BF_TOL:
            st2 = PhaseState(sg2, dl2, st.eta)
    if st2 is None:
        exists_pad = np.zeros((K, I_pad), dtype=bool)
        exists_pad[:K0, :I] = frags.exists()
        ct_np = make_cell_tables_np(p_pad, q_pad)  # host pass: block flip only
        st2 = block_flip_pass(ct_np, st.to_numpy(), read_base_np,
                              site_mask_np, exists_pad, ld)
        del ct_np
        st2 = PhaseState.from_numpy(*st2, device=device)
    prob = _overall_probability(ct, st2.sigma, st2.delta, st2.eta,
                                read_base, site_mask, split)
    consider(st2, prob)
    st = best_st

    # perturbation rounds (phase.rs:1198-1233)
    n_rounds = I // 4 + 1
    key = R.prng_key(int(rng.integers(0, np.iinfo(np.int64).max,
                                      dtype=np.int64)))
    best_st, _ = perturbation_phase(ct, best_st, best_st, best_prob,
                                    read_base, site_mask, conserved,
                                    n_rounds, key, split)
    if net:
        # safety net: accept the split-mode result only when its f64
        # decision margins clear the bound; otherwise recompute in f64
        # forced split mode has no exact rerun
        if not USE_F32_KERNELS and margin_of(best_st) < F32_SAFETY_TOL:
            return rerun_f64()
    if split:
        _note(kept=True)
    return best_st
