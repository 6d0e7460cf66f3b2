"""Frozen copy of ``tests/oracle_phase.py`` at commit
fbeccaa9682300b9b3ab6ff3e33e50e6f6928b91: the phasing
probability functions (longcallR/src/phase.rs:14-276), transcribed
literally."""

import math


def aki(sigma, delta, eta, base_allele, error_rate):
    if eta == 0:
        x = sigma * delta
    else:
        x = eta
    return (1.0 - error_rate) if base_allele == x else error_rate


def cal_sigma_delta_eta_log(sigma_k, delta, eta, ps, probs):
    lq1 = lq2 = lq3 = 0.0
    for i in range(len(delta)):
        lq1 += math.log10(aki(sigma_k, delta[i], eta[i], ps[i], probs[i]))
    for i in range(len(delta)):
        lq2 += math.log10(aki(1, delta[i], eta[i], ps[i], probs[i]))
        lq3 += math.log10(aki(-1, delta[i], eta[i], ps[i], probs[i]))
    return 1.0 - lq1 / (lq2 + lq3)


def cal_delta_eta_sigma_log(delta_i, eta_i, sigma, ps, probs):
    lq1 = lq2 = lq3 = lq4 = lq5 = 0.0
    prior_homref = math.log10(1.0 - 1.5 * 0.001)
    prior_homvar = math.log10(0.5 * 0.001)
    cov = len(sigma)
    if cov == 0:
        prior_het = math.log10(0.001)
    else:
        prior_het = math.log10(0.001) - cov * math.log10(2.0)
    for k in range(cov):
        lq1 += math.log10(aki(sigma[k], delta_i, eta_i, ps[k], probs[k]))
    if eta_i == 0:
        lq1 += prior_het
    elif eta_i == 1:
        lq1 += prior_homref
    else:
        lq1 += prior_homvar
    for k in range(cov):
        lq2 += math.log10(aki(sigma[k], delta_i, -1, ps[k], probs[k]))
        lq3 += math.log10(aki(sigma[k], delta_i, 0, ps[k], probs[k]))
        lq4 += math.log10(aki(sigma[k], delta_i, 1, ps[k], probs[k]))
        lq5 += math.log10(aki(sigma[k], -delta_i, 0, ps[k], probs[k]))
    lq2 += prior_homvar
    lq3 += prior_het
    lq4 += prior_homref
    lq5 += prior_het
    return 1.0 - lq1 / (lq2 + lq3 + lq4 + lq5)


def cal_phase_score_log(delta_i, eta_i, sigma, ps, probs):
    assert delta_i != 0 and eta_i == 0
    lq1 = lq2 = lq3 = 0.0
    for k in range(len(sigma)):
        lq1 += math.log10(aki(sigma[k], delta_i, eta_i, ps[k], probs[k]))
    for k in range(len(sigma)):
        lq2 += math.log10(aki(sigma[k], 1, eta_i, ps[k], probs[k]))
        lq3 += math.log10(aki(sigma[k], -1, eta_i, ps[k], probs[k]))
    return 1.0 - lq1 / (lq2 + lq3)


def cal_overall_probability(cells, sigma, delta, eta, active, phase_site):
    """cells: list of (k, i, p, prob)."""
    logp = 0.0
    for (k, i, p, prob) in cells:
        if not active[k] or sigma[k] == 0 or not phase_site[i]:
            continue
        logp += math.log10(aki(sigma[k], delta[i], eta[i], p, prob))
    return logp
