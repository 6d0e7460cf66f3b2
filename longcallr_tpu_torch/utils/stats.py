"""Statistics helpers for the allele-specific analysis layer.

Replaces the statsmodels/scipy pieces the reference scripts import
(longcallR-ase.py:10-11, longcallR-asj.py): Benjamini-Hochberg FDR,
beta-binomial two-sided test (vectorised over genes), Fisher exact, G-test
and GATK-style SOR.

Copied from ``longcallr_tpu/utils/stats.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
from scipy.stats import fisher_exact as _scipy_fisher


def fdr_bh(p_values: Sequence[float], alpha: float = 0.05
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Benjamini-Hochberg: returns (reject, adjusted p-values), matching
    statsmodels.stats.multitest.multipletests(method='fdr_bh') BIT-exactly:
    the correction divides by the ecdf factor arange(1,n+1)/n (not the
    algebraically-equal p*n/rank, which differs in the last ulp — the
    analysis-layer TSV byte gate compares str(float) of these values).
    Ties are order-insensitive (the suffix-cummin assigns every member of a
    tied run the same adjusted value), so the stable argsort is safe against
    statsmodels' default unstable one."""
    p = np.asarray(p_values, dtype=np.float64)
    n = p.shape[0]
    if n == 0:
        return np.zeros(0, bool), p
    order = np.argsort(p, kind="stable")
    ecdffactor = np.arange(1, n + 1) / float(n)
    ranked = p[order] / ecdffactor
    adj = np.minimum.accumulate(ranked[::-1])[::-1]
    adj = np.minimum(adj, 1.0)
    out = np.empty(n)
    out[order] = adj
    reject = out <= alpha
    return reject, out


def convert_mu_rho_to_alpha_beta(mu: float, rho: float) -> Tuple[float, float]:
    """longcallR-ase.py:15-22."""
    phi = (1.0 - rho) / rho - 1.0
    return mu * phi, (1.0 - mu) * phi


def _betabinom_pmf(ks: np.ndarray, n, alpha: float, beta: float) -> np.ndarray:
    """Beta-binomial pmf composed exactly like scipy's betabinom._logpmf
    (combiln + betaln(k+a, n-k+b) - betaln(a, b)) so tie comparisons against
    historical scipy-based p-values are preserved."""
    from scipy.special import betaln, gammaln

    ks = np.asarray(ks, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    combiln = gammaln(n + 1) - (gammaln(ks + 1) + gammaln(n - ks + 1))
    return np.exp(combiln + betaln(ks + alpha, n - ks + beta)
                  - betaln(alpha, beta))


def beta_binomial_two_sided(k_obs: int, n: int, mu: float, rho: float) -> float:
    """Two-sided beta-binomial p: sum of pmf(k) over k with
    pmf(k) <= pmf(k_obs), transcribed exactly from longcallR-ase.py:25-61 —
    scipy.stats.betabinom pmf values (the reference's own implementation;
    the gammaln composition in _betabinom_pmf differs at the last ulp) and a
    SEQUENTIAL k-ascending Python sum (the reference's genexpr sum; numpy's
    pairwise .sum() also differs at the last ulp). This is the scalar path
    the ASE TSV byte gate runs through."""
    from scipy.stats import betabinom

    alpha, beta = convert_mu_rho_to_alpha_beta(mu, rho)
    bb = betabinom(n, alpha, beta)
    pmf = bb.pmf(np.arange(n + 1))
    p_obs = pmf[int(k_obs)]
    # sum np.float64 SCALARS, not .tolist() floats: CPython >= 3.12 sum()
    # applies Neumaier compensation to Python floats but plain sequential
    # adds to np.float64 — the reference sums np.float64 pmf values, so the
    # compensated sum differs at the last ulp
    return float(sum(p for p in pmf if p <= p_obs))


def beta_binomial_two_sided_many(k_obs: np.ndarray, n: np.ndarray,
                                 mu: float, rho: float) -> np.ndarray:
    """Two-sided beta-binomial over many (k, n) observations, flattened
    into ONE vectorised pmf evaluation (total work Σ(n_i+1) gammaln calls
    instead of a scipy distribution object per gene). Agrees with the scalar
    reference-exact path to ~1e-14 (different pmf composition + summation
    order); the byte-gated ASE path uses the scalar form."""
    alpha, beta = convert_mu_rho_to_alpha_beta(mu, rho)
    k_obs = np.asarray(k_obs, dtype=np.int64)
    n = np.asarray(n, dtype=np.int64)
    out = np.ones(len(k_obs), dtype=np.float64)
    live = np.nonzero(n > 0)[0]
    if live.size == 0:
        return out
    nl = n[live]
    sizes = nl + 1
    offs = np.concatenate([[0], np.cumsum(sizes)])
    tot = int(offs[-1])
    row = np.repeat(np.arange(live.size), sizes)
    ks = np.arange(tot) - np.repeat(offs[:-1], sizes)
    pmf = _betabinom_pmf(ks, nl[row], alpha, beta)
    p_obs = pmf[offs[:-1] + k_obs[live]]
    sel = pmf <= p_obs[row]
    out[live] = np.bincount(row, weights=np.where(sel, pmf, 0.0),
                            minlength=live.size)
    return out


def fisher_exact_two_sided(a: int, b: int, c: int, d: int) -> float:
    return float(_scipy_fisher([[a, b], [c, d]], alternative="two-sided")[1])


def g_test_2x2(a: int, b: int, c: int, d: int) -> float:
    """G-test of independence on a 2x2 table with Williams-free raw G,
    chi2(1) tail (the scipy power_divergence(lambda_='log-likelihood')
    equivalent used by longcallR-asj.py)."""
    from scipy.stats import chi2

    obs = np.asarray([[a, b], [c, d]], dtype=np.float64)
    total = obs.sum()
    if total == 0:
        return 1.0
    row = obs.sum(axis=1, keepdims=True)
    col = obs.sum(axis=0, keepdims=True)
    exp = row * col / total
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(obs > 0, obs * np.log(obs / exp), 0.0)
    g = 2.0 * terms.sum()
    return float(chi2.sf(g, df=1))


def strand_odds_ratio(ref_fw: int, ref_rv: int, alt_fw: int, alt_rv: int) -> float:
    """GATK SOR with +1 pseudocounts (longcallR-asj.py variant of the same
    formula as candidate.rs:24-35, in f64)."""
    x00, x01 = ref_fw + 1.0, ref_rv + 1.0
    x10, x11 = alt_fw + 1.0, alt_rv + 1.0
    sym = (x00 * x11) / (x01 * x10) + (x01 * x10) / (x00 * x11)
    ref_ratio = min(x00, x01) / max(x00, x01)
    alt_ratio = min(x10, x11) / max(x10, x11)
    return math.log(sym) + math.log(ref_ratio) - math.log(alt_ratio)
