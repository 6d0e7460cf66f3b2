"""Matvec-form phasing half-steps (torch).

Port of ``longcallr_tpu/phasing/kernels_fast.py``. The masked log-emission
sums of the coordinate ascent decompose exactly over three fixed matrices
(per region, per ascent call):

    B = m ∘ lerr,   Dif = m ∘ (l1m - lerr),   Dp = m ∘ (l1m - lerr) ∘ p

with m the phase-site cell mask. Using match(x) = (1 + p·x)/2 on masked
cells (p ∈ {±1} there):

    L(σ=s)[k]  = rowB[k] + ½·rowDif[k] + ½·(s·(Dp u)[k] + (Dp v)[k])
    S_match[i] = colB[i] + ½·colDif[i] + ½·δ_i·(Dpᵀ σ)[i]
    S_flip[i]  = colB[i] + ½·colDif[i] − ½·δ_i·(Dpᵀ σ)[i]
    S_refe[i]  = colB[i] + ½·colDif[i] + ½·colDp[i]
    S_alte[i]  = colB[i] + ½·colDif[i] − ½·colDp[i]

where u_i = [η_i==0]·δ_i and v_i = [η_i≠0]·η_i. One ascent iteration costs
two matvecs with Dp.

Two forms: the f64 form (``Dp`` in f64, torch contractions), and the split
form, where ``Dp`` is stored as an exact two-term f32 sum ``hi + lo`` and
the two matvecs go to the hand kernels of ``cuda_kernels`` (f64
accumulation on the card). The split form's table reductions keep the JAX
package's contract: F32_CHUNK-chunked f32 partials combined in f64.

Every table may carry a leading region axis (a bucket of same-shape
regions: cells [B,K,I], ``dp2`` [2,B,K,I], row vectors [B,K], column
vectors [B,I], ``read_mask`` [B,K]); per member the values are those of
the unbatched build. State vectors carry the tables' leading axes, and may
carry one more for the members that share a table (the enumeration
configs: σ [C,K] over tables [K,I], or σ [B,C,K] over tables [B,K,I] that
``for_members`` has given the axis to broadcast over).
"""

from __future__ import annotations

import os as _os
from typing import NamedTuple, Tuple

import numpy as _np
import torch

from . import cuda_kernels as CK
from .kernels import (LOG10_1MERR_T, LOG10_ERR_T, PRIOR_HOMREF_LOG,
                      PRIOR_HOMVAR_LOG, TIE_TOL, _LOG10_HALF, _PRIOR_HET_BASE,
                      CellTables, _table, capped_q, f64)

f32 = torch.float32


class FastTables(NamedTuple):
    """Precomputed reductions for one ascent call (fixed masks)."""

    dp: torch.Tensor       # [K,I] m∘diff∘p
    row_b: torch.Tensor    # [K] Σ_i m∘lerr
    row_dif: torch.Tensor  # [K] Σ_i m∘diff
    col_b: torch.Tensor    # [I] Σ_k mS∘lerr
    col_dif: torch.Tensor  # [I] Σ_k mS∘diff
    col_dp: torch.Tensor   # [I] Σ_k mS∘diff∘p
    row_cells: torch.Tensor  # [K] phase-site cell count per read
    cov: torch.Tensor      # [I] gathered cell count per SNP (over mS)
    read_mask: torch.Tensor  # [K] the ascent's active read set


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


def make_fast_tables(ct: CellTables, read_mask, site_mask) -> FastTables:
    """Build the fixed reductions. ``read_mask`` is the ascent's active read
    set (read_base & σ≠0 — constant during an ascent since σ only flips
    sign)."""
    m = site_mask[..., None, :] & ct.exists
    z = _zero(ct.l1m)
    diff = torch.where(m, ct.l1m - ct.lerr, z)
    lerr = torch.where(m, ct.lerr, z)
    dp = diff * ct.p
    ms = m & read_mask[..., :, None]
    return FastTables(
        dp=dp,
        row_b=lerr.sum(dim=-1),
        row_dif=diff.sum(dim=-1),
        col_b=torch.where(ms, ct.lerr, z).sum(dim=-2),
        col_dif=torch.where(ms, diff, z).sum(dim=-2),
        col_dp=torch.where(ms, dp, z).sum(dim=-2),
        row_cells=m.sum(dim=-1),
        cov=ms.sum(dim=-2),
        read_mask=read_mask,
    )


def for_members(ft):
    """Tables of a bucket ([B, ...]) for state vectors that carry one more
    axis, the members that share a region's table (σ [B,C,K], δ/η
    [B,C,I]): every vector gets the axis to broadcast over, and so does the
    f64 ``dp``; the split ``dp2`` stays [2,B,K,I], since the hand kernels
    take the members per table as it is."""
    vec = [v.unsqueeze(-2) for v in ft[1:]]
    if isinstance(ft, FastTables32):
        return FastTables32(ft.dp2, *vec)
    return FastTables(ft.dp.unsqueeze(-3), *vec)


def _uv(delta, eta):
    zero = _zero(delta)
    u = torch.where(eta == 0, delta, zero)
    v = torch.where(eta == 0, zero, eta)
    return torch.stack([u, v], dim=-1)            # [..., I, 2]


def fast_read_logliks(ft: FastTables, delta, eta):
    """(L(+1), L(-1), cell counts) per read — matvec form."""
    duv = torch.matmul(ft.dp, _uv(delta, eta))
    du, dv = duv[..., 0], duv[..., 1]
    base = ft.row_b + 0.5 * ft.row_dif + 0.5 * dv
    return base + 0.5 * du, base - 0.5 * du, ft.row_cells


def _snp_from_dts(ft, dts, delta):
    base = ft.col_b + 0.5 * ft.col_dif
    half = 0.5 * delta * dts
    return (base + half, base - half, base + 0.5 * ft.col_dp,
            base - 0.5 * ft.col_dp, ft.cov)


def fast_snp_sums(ft: FastTables, sigma, delta):
    """(S_match, S_flip, S_refe, S_alte, cov) per SNP — one matvec over the
    active reads."""
    s = torch.where(ft.read_mask, sigma, _zero(sigma))
    dts = torch.matmul(s.unsqueeze(-2), ft.dp).squeeze(-2)
    return _snp_from_dts(ft, dts, delta)


def _objective(ft, sigma, duv):
    du, dv = duv[..., 0], duv[..., 1]
    per_read = ft.row_b + 0.5 * ft.row_dif + 0.5 * (sigma * du + dv)
    return torch.where(ft.read_mask, per_read, _zero(per_read)).sum(dim=-1)


def fast_overall_probability(ft: FastTables, sigma, delta, eta):
    """cal_overall_probability in matvec form over the active-read set."""
    return _objective(ft, sigma, torch.matmul(ft.dp, _uv(delta, eta)))


# ---------------------------------------------------------------------------
# hi/lo f32-split form: the Dp matvecs on the hand kernels
# ---------------------------------------------------------------------------

F32_CHUNK = 512


class FastTables32(NamedTuple):
    """FastTables with Dp in hi/lo f32-split form, stacked [2,K,I]
    (dp2[0] = hi, dp2[1] = lo); the vectors stay f64."""

    dp2: torch.Tensor
    row_b: torch.Tensor
    row_dif: torch.Tensor
    col_b: torch.Tensor
    col_dif: torch.Tensor
    col_dp: torch.Tensor
    row_cells: torch.Tensor
    cov: torch.Tensor
    read_mask: torch.Tensor


def split_f32(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact two-term f32 split of an f64 tensor: a ≈ hi + lo to ~2⁻⁴⁸."""
    hi = a.to(f32)
    lo = (a - hi.to(f64)).to(f32)
    return hi, lo


def make_fast_tables32(ct: CellTables, read_mask, site_mask) -> FastTables32:
    ft = make_fast_tables(ct, read_mask, site_mask)
    hi, lo = split_f32(ft.dp)
    return FastTables32(torch.stack([hi, lo]), *ft[1:])   # [2, ..., K, I]


# f32-split emission tables: diff = l1m − lerr; each f64 table value is an
# exact two-term f32 sum hi + lo (numpy at module level)
_DIFF_NP = LOG10_1MERR_T - LOG10_ERR_T
_DIFF_HI_NP = _DIFF_NP.astype(_np.float32)
with _np.errstate(invalid="ignore"):
    _DIFF_LO_NP = (_DIFF_NP - _DIFF_HI_NP.astype(_np.float64)).astype(_np.float32)


_DIFF_ON: dict = {}


def _diff_tables(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split diff tables on ``dev``, copied there once (a device
    program's capture may not copy from the host)."""
    key = (dev.type, dev.index)
    tabs = _DIFF_ON.get(key)
    if tabs is None:
        tabs = _DIFF_ON.setdefault(key, (
            torch.as_tensor(_DIFF_HI_NP, device=dev),
            torch.as_tensor(_DIFF_LO_NP, device=dev)))
    return tabs


def constants_on(dev: torch.device) -> None:
    """Copy the emission tables to ``dev`` now, outside any piece of a
    device program (whose capture may not copy from the host)."""
    _diff_tables(dev)
    for t in (LOG10_ERR_T, LOG10_1MERR_T):
        _table(t, dev)


def _chunks(n: int) -> int:
    c = min(F32_CHUNK, n)
    while n % c:          # shapes are power-of-two padded; guard odd callers
        c -= 1
    return c


def _ones_sum_rows(a32: torch.Tensor) -> torch.Tensor:
    """Σ over the minor axis of [..., K, I] f32: F32_CHUNK-chunked f32
    partials combined in f64 (the split matvecs' accumulation contract in
    the JAX package). A leading region axis changes neither the chunks nor
    the order in which they are combined."""
    *lead, K, I = a32.shape
    c = _chunks(I)
    parts = a32.reshape(*lead, K, I // c, c).sum(dim=-1, dtype=f32)
    return parts.to(f64).sum(dim=-1)


def _ones_sum_cols(a32: torch.Tensor) -> torch.Tensor:
    """Σ over the major axis of [..., K, I] f32 (see _ones_sum_rows)."""
    *lead, K, I = a32.shape
    c = _chunks(K)
    parts = a32.reshape(*lead, K // c, c, I).sum(dim=-2, dtype=f32)
    return parts.to(f64).sum(dim=-2)


def fast_tables32_from_compact(cc, read_mask, site_mask) -> FastTables32:
    """FastTables32 built directly from CompactCells ([K,I], or [B,K,I]
    with masks [B,K] / [B,I]): f32 table gathers and chunked f32
    reductions, no [K,I] f64 intermediate.

    Exactness vs the expand-then-split build (make_fast_tables32):
      * dp2 is bit-identical: f32(diff·p) == f32(diff)·p for p ∈ {±1};
      * row_b/col_b are exact integer q-sums scaled by −0.1 in f64;
      * row_dif/col_dif/col_dp use f32-chunked partials with f64 chunk
        combine (~1e-4 absolute), inside the split mode's error bound and
        the F32_SAFETY_TOL margin recheck."""
    p8, q8 = cc.p, cc.q
    dev = p8.device
    exists = p8 != 0
    m = site_mask[..., None, :] & exists
    ms = m & read_mask[..., :, None]
    qi = capped_q(q8)
    hi_t, lo_t = _diff_tables(dev)
    dif_hi = hi_t[qi]
    dif_lo = lo_t[qi]
    p32 = p8.to(f32)
    zero = torch.zeros((), dtype=f32, device=dev)
    dp_hi = torch.where(m, dif_hi * p32, zero)
    dp_lo = torch.where(m, dif_lo * p32, zero)
    qf = qi.to(f32)
    qm = torch.where(m, qf, zero)
    qms = torch.where(ms, qf, zero)
    rm = read_mask[..., :, None]
    row_b = -0.1 * _ones_sum_rows(qm)
    row_dif = (_ones_sum_rows(torch.where(m, dif_hi, zero))
               + _ones_sum_rows(torch.where(m, dif_lo, zero)))
    col_b = -0.1 * _ones_sum_cols(qms)
    col_dif = (_ones_sum_cols(torch.where(ms, dif_hi, zero))
               + _ones_sum_cols(torch.where(ms, dif_lo, zero)))
    col_dp = (_ones_sum_cols(torch.where(rm, dp_hi, zero))
              + _ones_sum_cols(torch.where(rm, dp_lo, zero)))
    row_cells = _ones_sum_rows(m.to(f32)).to(torch.int32)
    cov = _ones_sum_cols(ms.to(f32)).to(torch.int32)
    return FastTables32(torch.stack([dp_hi, dp_lo]), row_b, row_dif, col_b,
                        col_dif, col_dp, row_cells, cov, read_mask)


def _matvec_rows(dp2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Dp @ x for x [..., I, 2] (both columns in one pass over Dp) on the
    split tables → [..., K, 2] f64 (cuda_kernels.dual_matvec_rows)."""
    return CK.dual_matvec_rows(dp2[0], dp2[1],
                               x if x.dtype is f64 else x.to(f64))


def _matvec_cols(dp2: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Dpᵀ @ s for s [..., K] on the split tables → [..., I] f64
    (cuda_kernels.matvec_cols)."""
    return CK.matvec_cols(dp2[0], dp2[1],
                          s if s.dtype is f64 else s.to(f64))


def fast_read_logliks32(ft: FastTables32, delta, eta):
    duv = _matvec_rows(ft.dp2, _uv(delta, eta))
    du, dv = duv[..., 0], duv[..., 1]
    base = ft.row_b + 0.5 * ft.row_dif + 0.5 * dv
    return base + 0.5 * du, base - 0.5 * du, ft.row_cells


def fast_snp_sums32(ft: FastTables32, sigma, delta):
    dts = _matvec_cols(ft.dp2, torch.where(ft.read_mask, sigma, _zero(sigma)))
    return _snp_from_dts(ft, dts, delta)


def fast_overall_probability32(ft: FastTables32, sigma, delta, eta):
    return _objective(ft, sigma, _matvec_rows(ft.dp2, _uv(delta, eta)))


# ---------------------------------------------------------------------------
# Device block-flip pass (cross_optimize_by_block, phase.rs:1298-1394)
# ---------------------------------------------------------------------------
#
# Every block's decision is computed against the SAME current state, so the
# whole pass is column reductions + elementwise work over the split tables
# with one extra contraction (plain torch: it is an XLA op, not a Pallas
# kernel, in the JAX package). A per-block decision margin flags near-tie
# regions for the exact host recompute (LONGCALLR_BF_SAFETY overrides the
# per-site tolerance, default 1e-3).

_BF_ENV = _os.environ.get("LONGCALLR_BF_SAFETY", "")
F32_BF_TOL: float = (float(_BF_ENV) if _BF_ENV else 1e-3)


def fast_block_flip32(ft: FastTables32, p8, sigma, delta, eta, site_mask,
                      block_id):
    """block_flip_pass over the split tables for one region, or for a
    bucket of regions when every argument carries the leading region axis.

    ``block_id`` is [..., I] int (−1 = unblocked column). Returns
    (new_sigma, new_delta, margin) with ``margin`` [...] = min over blocks
    of |Σ_block Δq| / block_size; margin < F32_BF_TOL means some block
    decision sat inside the f32 error envelope and the caller recomputes
    the pass exactly on the host.

        S'_match = S_flip + δ·H      S'_flip = S_match − δ·H
        H[i] = Σ_k (m∘diff∘p)[k,i] · σ_k · F[k,i]

    with F[k,i] = 1 on cells of a read's own fully-containing block."""
    *lead, K, I = p8.shape
    dev = p8.device
    exists = p8 != 0
    s_match, s_flip, s_refe, s_alte, cov = fast_snp_sums32(ft, sigma, delta)

    bid = block_id.long()
    bid_r = bid[..., None, :]                               # [..., 1, I]
    big = torch.full((), I + 1, dtype=torch.long, device=dev)
    small = torch.full((), -2, dtype=torch.long, device=dev)
    minus1 = torch.full((), -1, dtype=torch.long, device=dev)
    bmin = torch.where(exists, bid_r, big).min(dim=-1).values
    bmax = torch.where(exists, bid_r, small).max(dim=-1).values
    full_in = torch.where((bmin == bmax) & (bmax >= 0), bmax, minus1)
    full_c = full_in[..., :, None]                          # [..., K, 1]
    F = (full_c == bid_r) & (bid_r >= 0)

    # the one new contraction: chunked f32 partials, f64 chunk combine
    c = _chunks(K)
    sf = (torch.where(ft.read_mask, sigma, _zero(sigma)).to(f32)[..., :, None]
          * F.to(f32))
    d = ft.dp2.reshape(2, *lead, K // c, c, I)
    parts = (d * sf.reshape(1, *lead, K // c, c, I)).sum(dim=-2, dtype=f32)
    H = (parts[0].to(f64) + parts[1].to(f64)).sum(dim=-2)

    s_match_new = s_flip + delta * H
    s_flip_new = s_match - delta * H

    ph = torch.where(cov == 0,
                     torch.full(cov.shape, _PRIOR_HET_BASE, dtype=f64,
                                device=dev),
                     _PRIOR_HET_BASE - cov.to(f64) * _LOG10_HALF)

    def q_of(sm, sfl, e):
        n1 = torch.where(e == 0, sm + ph,
                         torch.where(e == 1, s_refe + PRIOR_HOMREF_LOG,
                                     s_alte + PRIOR_HOMVAR_LOG))
        dd = ((s_alte + PRIOR_HOMVAR_LOG) + (sm + ph)
              + (s_refe + PRIOR_HOMREF_LOG) + (sfl + ph))
        return 1.0 - n1 / dd

    dq = q_of(s_match_new, s_flip_new, eta) - q_of(s_match, s_flip, eta)

    # per-block Δ sums over an NB == I one-hot (block count ≤ site count)
    ar = torch.arange(I, device=dev)
    bid_c = bid[..., :, None]                               # [..., I, 1]
    onehot = (bid_c == ar) & (bid_c >= 0)                   # [..., I, NB]
    dsum = torch.where(onehot, dq[..., :, None], _zero(dq)).sum(dim=-2)
    ncols = onehot.sum(dim=-2)
    has = ncols > 0

    # exact global-flip symmetry: when no active masked cell at a block's
    # columns belongs to a partially-overlapping read, the host's Σ Δq is
    # exactly 0.0 and it never flips — decided with integer logic here
    m0 = exists & site_mask[..., None, :] & ft.read_mask[..., :, None]
    part = m0 & (bid_r >= 0) & (full_c != bid_r)
    cnt_col = part.sum(dim=-2)
    npart = torch.where(onehot, cnt_col[..., :, None],
                        torch.zeros((), dtype=cnt_col.dtype, device=dev)
                        ).sum(dim=-2)
    sym = has & (npart == 0)

    flipb = has & ~sym & (dsum > TIE_TOL)
    inf = torch.full((), float("inf"), dtype=f64, device=dev)
    margin = torch.where(has & ~sym,
                         dsum.abs() / ncols.to(f64).clamp(min=1.0),
                         inf).min(dim=-1).values

    flipb_r = flipb[..., None, :]                           # [..., 1, NB]
    fb_col = (onehot & flipb_r).any(dim=-1)
    new_delta = torch.where(fb_col, -delta, delta)
    covers = (exists & site_mask[..., None, :] & F).any(dim=-1)
    oneh_k = full_c == ar
    flip_read = (oneh_k & flipb_r).any(dim=-1) & covers & ft.read_mask
    new_sigma = torch.where(flip_read, -sigma, sigma)
    return new_sigma, new_delta, margin
