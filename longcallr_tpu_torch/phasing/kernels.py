"""Phasing probability kernels: masked reductions over [K,I] cells (torch).

Port of ``longcallr_tpu/phasing/kernels.py``: the reference's scalar
probability functions (``longcallR/src/phase.rs:14-276``) as batched masked
reductions — ``aki`` emissions, the read-level surrogate
``cal_sigma_delta_eta_log`` (phase.rs:77-96), the SNP-level
``cal_delta_eta_sigma_log`` with genotype priors (phase.rs:128-176) and the
overall objective (phase.rs:257-276). The surrogate ratios
``1 - logQ1/(ΣlogQs)`` are the same f64 expressions as the reference.

Tables are [K, I], or [B, K, I] for a bucket of regions (``site_mask``
[B, I] then); the state vectors may carry leading batch axes (σ [..., K],
δ/η [..., I]) that broadcast over the tables — the enumeration path runs
its configs that way. Every f64 quantity gets its
dtype explicitly (torch's default dtype is f32).
"""

from __future__ import annotations

import math
import os as _os
from typing import NamedTuple, Tuple

import numpy as _np
import torch

from ..config import MAX_BASE_QUALITY

f64 = torch.float64

# log10 emission tables indexed by capped baseq: error term and 1-error term
# (prob = 10^(-q/10), fragment.rs:133)
_QS = _np.arange(MAX_BASE_QUALITY + 1, dtype=_np.float64)
LOG10_ERR_T = -_QS / 10.0  # log10(10^(-q/10)) == -q/10 exactly
with _np.errstate(divide="ignore"):
    LOG10_1MERR_T = _np.log10(-_np.expm1(-_QS / 10.0 * math.log(10.0)))
# q = 0: err = 1 → log10(1-err) = -inf, as in the reference

# genotype priors (phase.rs:136-144)
PRIOR_HOMREF_LOG = math.log10(1.0 - 1.5 * 0.001)
PRIOR_HOMVAR_LOG = math.log10(0.5 * 0.001)
_LOG10_HALF = math.log10(2.0)
_PRIOR_HET_BASE = math.log10(0.001)

# Decision tie tolerance (LONGCALLR_TIE_TOL, the JAX package's knob): the
# ascent/keep-best decisions compare f64 sums whose summation order differs
# between implementations; quantizing every decision at TIE_TOL makes them
# order-independent at structural ties (see the JAX package's kernels.py).
TIE_TOL = float(_os.environ.get("LONGCALLR_TIE_TOL", "1e-9"))


class CellTables(NamedTuple):
    """Fixed per-region cell data (torch tensors on the phasing device, or
    host numpy for the assignment layer)."""

    p: object        # [K,I] f64 in {-1,0,+1}
    lerr: object     # [K,I] f64 log10(err), 0 where no cell
    l1m: object      # [K,I] f64 log10(1-err), 0 where no cell
    exists: object   # [K,I] bool


def make_cell_tables_np(p_np, baseq_np) -> CellTables:
    """Host (numpy) cell tables — used by the assignment/rescue layer."""
    p = _np.asarray(p_np, dtype=_np.float64)
    q = _np.asarray(baseq_np, dtype=_np.int32)
    exists = p != 0
    lerr = _np.where(exists, LOG10_ERR_T[q], 0.0)
    l1m = _np.where(exists, LOG10_1MERR_T[q], 0.0)
    return CellTables(p=p, lerr=lerr, l1m=l1m, exists=exists)


class CompactCells(NamedTuple):
    """Transfer form of the per-region cell data: 2 bytes/cell. The f64
    emission tables are expanded on the device (expand_cells)."""

    p: torch.Tensor   # [K,I] int8 in {-1,0,+1} (0 = no cell)
    q: torch.Tensor   # [K,I] uint8 capped baseq

    @classmethod
    def from_numpy(cls, p, q, device=torch.device("cpu")) -> "CompactCells":
        return cls(torch.as_tensor(_np.asarray(p, _np.int8), device=device),
                   torch.as_tensor(_np.asarray(q, _np.uint8), device=device))

    def to_numpy(self) -> Tuple[_np.ndarray, _np.ndarray]:
        return self.p.cpu().numpy(), self.q.cpu().numpy()


_TABLES_ON: dict = {}


def _table(t_np: _np.ndarray, device) -> torch.Tensor:
    """A module table on ``device``, copied there once (a device
    program's capture may not copy from the host)."""
    device = torch.device(device)
    key = (id(t_np), device.type, device.index)
    t = _TABLES_ON.get(key)
    if t is None:
        t = _TABLES_ON.setdefault(key, torch.as_tensor(t_np, dtype=f64,
                                                       device=device))
    return t


def capped_q(q: torch.Tensor) -> torch.Tensor:
    """baseq as an index into the log10 tables (explicit clamp; baseq is
    capped at MAX_BASE_QUALITY upstream, fragment.rs:127-131)."""
    return q.long().clamp(max=MAX_BASE_QUALITY)


def expand_cells(cc: CompactCells) -> CellTables:
    """CompactCells → CellTables on the cells' device (an exact gather from
    the same f64 log10 tables as make_cell_tables_np)."""
    dev = cc.p.device
    exists = cc.p != 0
    qi = capped_q(cc.q)
    zero = torch.zeros((), dtype=f64, device=dev)
    lerr = torch.where(exists, _table(LOG10_ERR_T, dev)[qi], zero)
    l1m = torch.where(exists, _table(LOG10_1MERR_T, dev)[qi], zero)
    return CellTables(p=cc.p.to(f64), lerr=lerr, l1m=l1m, exists=exists)


def as_tables(ct) -> CellTables:
    """Accept either expanded CellTables or CompactCells."""
    return expand_cells(ct) if isinstance(ct, CompactCells) else ct


def _cell_term(ct: CellTables, x) -> torch.Tensor:
    """log10 aki per cell for target allele x ∈ {-1,+1} (phase.rs:32-49):
    (p == x) ? log10(1-err) : log10(err)."""
    return torch.where(ct.p == x, ct.l1m, ct.lerr)


def _masked_sum(m, v, dim):
    return torch.where(m, v, torch.zeros((), dtype=v.dtype,
                                         device=v.device)).sum(dim=dim)


def read_logliks(ct: CellTables, delta, eta, site_mask):
    """Per-read log-sums L(σ=+1), L(σ=-1) over masked cells, plus per-read
    cell counts. x = σ·δ_i where η_i==0 else η_i (phase.rs:32-49).
    ``site_mask`` [..., I]."""
    m = site_mask[..., None, :] & ct.exists
    x_plus = torch.where(eta == 0, delta, eta)[..., None, :]
    x_minus = torch.where(eta == 0, -delta, eta)[..., None, :]
    tp = _masked_sum(m, _cell_term(ct, x_plus), -1)
    tm = _masked_sum(m, _cell_term(ct, x_minus), -1)
    return tp, tm, m.sum(dim=-1)


def sigma_q(lp, lm, sigma):
    """(q, qn) per read: the surrogate 1 - logQ1/(logQ2+logQ3)
    (phase.rs:77-96) for current σ and flipped σ."""
    d = lp + lm
    l_cur = torch.where(sigma > 0, lp, lm)
    l_flip = torch.where(sigma > 0, lm, lp)
    return 1.0 - l_cur / d, 1.0 - l_flip / d


def snp_sums(ct: CellTables, sigma, delta, read_mask, site_mask):
    """Per-SNP masked sums feeding cal_delta_eta_sigma_log
    (phase.rs:128-176): (S_match, S_flip, S_refe, S_alte, cov)."""
    m = site_mask[..., None, :] & ct.exists & read_mask[..., :, None]
    x_match = sigma[..., :, None] * delta[..., None, :]
    s_match = _masked_sum(m, _cell_term(ct, x_match), -2)
    s_flip = _masked_sum(m, _cell_term(ct, -x_match), -2)
    s_refe = _masked_sum(m, _cell_term(ct, 1.0), -2)
    s_alte = _masked_sum(m, _cell_term(ct, -1.0), -2)
    return s_match, s_flip, s_refe, s_alte, m.sum(dim=-2)


def prior_het_log(cov):
    """Het-var prior log10(0.001) - cov·log10(2) (phase.rs:139-144)."""
    return torch.where(cov == 0,
                       torch.full(cov.shape, _PRIOR_HET_BASE, dtype=f64,
                                  device=cov.device),
                       _PRIOR_HET_BASE - cov.to(f64) * _LOG10_HALF)


def snp_qs(s_match, s_flip, s_refe, s_alte, cov):
    """(q1, q2, q3, q4) per SNP for the four candidate (δ, η) states of
    cross_optimize (phase.rs:904-907): (δ,0), (-δ,0), (δ,+1), (δ,-1)."""
    ph = prior_het_log(cov)
    n1 = s_match + ph
    n2 = s_flip + ph
    n3 = s_refe + PRIOR_HOMREF_LOG
    n4 = s_alte + PRIOR_HOMVAR_LOG
    d = n4 + n1 + n3 + n2  # logq2+logq3+logq4+logq5 with priors (phase.rs:159-169)
    return 1.0 - n1 / d, 1.0 - n2 / d, 1.0 - n3 / d, 1.0 - n4 / d


def snp_q_for(s_match, s_flip, s_refe, s_alte, cov, eta):
    """cal_delta_eta_sigma_log for the CURRENT (δ, η) of each SNP."""
    q1, q2, q3, q4 = snp_qs(s_match, s_flip, s_refe, s_alte, cov)
    return torch.where(eta == 0, q1, torch.where(eta == 1, q3, q4))


def phase_score_q(ct: CellTables, sigma, delta_i, read_mask,
                  col_mask) -> torch.Tensor:
    """cal_phase_score_log for one SNP column (phase.rs:238-255): scalar
    1 - L(δ)/(L(+1)+L(-1)) with η=0, over the masked cells of that column.

    ``col_mask``[k,i] selects exactly the gathered cells; delta_i ∈ {±1}.
    Returns the surrogate q (phase score is -10·log10(1-q) at the caller).
    """
    m = col_mask & ct.exists & read_mask[:, None]
    x_plus = sigma[:, None] * 1.0
    lp = _masked_sum(m, _cell_term(ct, x_plus), (-2, -1))
    lm = _masked_sum(m, _cell_term(ct, -x_plus), (-2, -1))
    l_cur = torch.where(torch.as_tensor(delta_i) > 0, lp, lm)
    return 1.0 - l_cur / (lp + lm)


def overall_probability(ct: CellTables, sigma, delta, eta, read_mask,
                        site_mask):
    """cal_overall_probability (phase.rs:257-276): Σ log10 aki over
    phase-site cells of assigned active reads."""
    m = site_mask[..., None, :] & ct.exists & read_mask[..., :, None]
    x = torch.where(eta[..., None, :] == 0,
                    sigma[..., :, None] * delta[..., None, :],
                    eta[..., None, :] * torch.ones_like(sigma)[..., :, None])
    return _masked_sum(m, _cell_term(ct, x), (-2, -1))
