"""Per-haplotype somatic mutation posterior.

Port of ``longcallR/src/somatic.rs:5-80`` (calculate_prob_somatic) and
``src/snpfrags.rs:735-771`` (detect_somatic_by_het), fed by the third-pass
baseq gather of ``src/snpfrags.rs:56-189`` (see
``phasing.fragments.gather_somatic_hap_quals``). The call site is commented
out in the reference's default path (thread.rs:187); here it is exposed
behind ``CallerConfig``-level opt-in for completeness.

Priors: som 5e-6, het 5e-4 per haplotype; ``purity`` mixes alt/ref error
channels for the somatic class (0.3 at the reference call site).

The per-haplotype products run SEQUENTIALLY over the gathered baseqs (all
ref quals, then all alt quals) so the f64 rounding matches the reference's
accumulation loops bit-for-bit; bucket order is the BAM fetch order the
reference's Vec pushes produce.

Copied from ``longcallr_tpu/ops/somatic.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

SOM_RATE = 5.0 / 1_000_000.0
HET_RATE = 1.0 / 2_000.0
REF_RATE = 1.0 - HET_RATE - SOM_RATE


def _hap_class(ref_baseqs, alt_baseqs, purity: float) -> Tuple[int, float]:
    """Posterior class for one haplotype: 0 ref, 1 het, 2 som, with its
    probability. Exact sequential transcription of somatic.rs:12-44 (hap1
    block; hap2 is the same code repeated)."""
    p_ref = 1.0
    p_het = 1.0
    p_som = 1.0
    for q in np.asarray(ref_baseqs).tolist():
        eps = 10.0 ** (-(float(q) / 10.0))
        p_ref *= 1.0 - eps                                    # ref->ref
        p_het *= eps                                          # alt->ref
        p_som *= purity * eps + (1.0 - purity) * (1.0 - eps)
    for q in np.asarray(alt_baseqs).tolist():
        eps = 10.0 ** (-(float(q) / 10.0))
        p_ref *= eps                                          # ref->alt
        p_het *= 1.0 - eps                                    # alt->alt
        p_som *= purity * (1.0 - eps) + (1.0 - purity) * eps
    wr = p_ref * REF_RATE
    wh = p_het * HET_RATE
    ws = p_som * SOM_RATE
    total = wr + wh + ws
    pr, ph, ps = wr / total, wh / total, ws / total
    if ps > pr and ps > ph:
        return 2, float(ps)
    if ph > pr and ph > ps:
        return 1, float(ph)
    return 0, float(pr)


def calculate_prob_somatic(hap1_ref_baseqs, hap1_alt_baseqs,
                           hap2_ref_baseqs, hap2_alt_baseqs,
                           purity: float = 0.3):
    """(hap1_class, hap1_prob, hap2_class, hap2_prob) — somatic.rs:5-80."""
    c1, p1 = _hap_class(hap1_ref_baseqs, hap1_alt_baseqs, purity)
    c2, p2 = _hap_class(hap2_ref_baseqs, hap2_alt_baseqs, purity)
    return c1, p1, c2, p2


def _somatic_score(prob: float) -> float:
    """-10·log10(1 - prob), Rust semantics: +inf when prob == 1 rather than
    a raised error (snpfrags.rs:754,762)."""
    with np.errstate(divide="ignore"):
        return float(-10.0 * np.log10(np.float64(1.0) - np.float64(prob)))


def _apply(cands, i: int, h1r, h1a, h2r, h2a, purity: float) -> None:
    """Classification + score write-back for one site (snpfrags.rs:750-770)."""
    c1, p1, c2, p2 = calculate_prob_somatic(h1r, h1a, h2r, h2a, purity)
    if c1 == 0 and c2 == 2:
        score = _somatic_score(p2)
    elif c1 == 2 and c2 == 0:
        score = _somatic_score(p1)
    else:
        return
    cands.somatic[i] = True
    cands.variant_type[i] = 1
    cands.somatic_score[i] = score


def detect_somatic_by_het(frags, cands, purity: float = 0.3) -> None:
    """snpfrags.rs:735-771: route the third-pass baseq gather by the phased
    read assignment (qname → assignment, 1/2 only, last-wins like the
    reference's HashMap insert over fragments) and test each candidate-time
    somatic site; 'somatic' iff one haplotype is called ref and the other
    som. Sets cands.somatic / somatic_score / variant_type.

    When ``frags.somatic_gather`` is absent (hand-constructed matrices with
    no BAM context), falls back to the fragment-cell approximation: p/baseq
    cells at the currently-flagged sites. The fallback differs from the
    reference pass at dense somatic sites (cells dropped, fragment.rs:148)
    and for sites rescue already reinstated (flag cleared) — the gather
    path has neither gap."""
    gather = getattr(frags, "somatic_gather", None)
    if gather is not None:
        if gather.som_idx.size == 0 or frags.n_frags == 0:
            return
        amap: Dict[str, int] = {}
        for k in range(frags.n_frags):
            a = int(frags.assignment[k])
            if a == 1 or a == 2:
                amap[frags.qnames[k]] = a
        if not amap:
            # every bucket empty → all sites classify (ref, ref) → no hit
            return
        # assignment per gathered record (0 = not a phased fragment)
        rec_asg = np.asarray([amap.get(q, 0) for q in gather.rec_qnames],
                             np.int8)
        cell_asg = rec_asg[gather.cell_rec] if len(gather.cell_rec) else \
            np.empty(0, np.int8)
        # one STABLE sort groups cells by site while preserving record
        # (fetch) order within each site — the reference's Vec push order —
        # instead of an O(sites × cells) mask scan per site
        order = np.argsort(gather.cell_site, kind="stable")
        site_sorted = gather.cell_site[order]
        asg_s = cell_asg[order]
        isr_s = gather.cell_is_ref[order]
        bq_s = gather.cell_baseq[order]
        S = gather.som_idx.size
        starts = np.searchsorted(site_sorted, np.arange(S + 1))
        for s, i in enumerate(gather.som_idx.tolist()):
            sl = slice(starts[s], starts[s + 1])
            asg = asg_s[sl]
            isr = isr_s[sl]
            bq = bq_s[sl]
            _apply(cands, i,
                   bq[(asg == 1) & isr], bq[(asg == 1) & ~isr],
                   bq[(asg == 2) & isr], bq[(asg == 2) & ~isr], purity)
        return

    # fallback: fragment-cell approximation (no BAM context)
    som_idx = np.nonzero(cands.cand_somatic)[0]
    if som_idx.size == 0 or frags.n_frags == 0:
        return
    assigned = frags.assignment  # 1/2 from the phasing pass
    ref_in = ((cands.alleles[:, 0] == cands.ref_base)
              | (cands.alleles[:, 1] == cands.ref_base))
    for i in som_idx.tolist():
        if not ref_in[i]:
            continue
        col_p = frags.p[:, i]
        col_q = frags.baseq[:, i]
        _apply(cands, i,
               col_q[(assigned == 1) & (col_p == 1)],
               col_q[(assigned == 1) & (col_p == -1)],
               col_q[(assigned == 2) & (col_p == 1)],
               col_q[(assigned == 2) & (col_p == -1)], purity)
