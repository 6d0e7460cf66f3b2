"""Frozen copy of ``tests/oracle_candidates.py`` at commit
fbeccaa9682300b9b3ab6ff3e33e50e6f6928b91: a literal
transcription of SNPFrag::get_candidate_snps
(longcallR/src/candidate.rs:54-528) over per-column quality lists."""

import math

import numpy as np
from scipy.stats import binom

THETA = 0.001
ACGT = "ACGT"


def cal_strand_odds_ratio(ref_fw, ref_rv, alt_fw, alt_rv):
    x00 = np.float32(ref_fw + 1)
    x01 = np.float32(ref_rv + 1)
    x10 = np.float32(alt_fw + 1)
    x11 = np.float32(alt_rv + 1)
    sym = (x00 * x11) / (x01 * x10) + (x01 * x10) / (x00 * x11)
    rr = min(x00, x01) / max(x00, x01)
    ar = min(x10, x11) / max(x10, x11)
    return np.float32(np.log(sym) + np.log(rr) - np.log(ar))


SOR_THRESHOLD = cal_strand_odds_ratio(5, 5, 9, 1)


def binomial_two_tailed(successes, trials, p=0.5):
    if successes == 0:
        return 2.0 * binom.cdf(0, trials, p)
    if successes == trials:
        return 2.0 * (1.0 - binom.cdf(trials - 1, trials, p))
    return 2.0 * min(binom.cdf(successes, trials, p),
                     1.0 - binom.cdf(successes - 1, trials, p))


def get_two_major_alleles(cnt4, ref_base_ch):
    x = sorted(zip(ACGT, cnt4.tolist()), key=lambda t: -t[1])  # stable
    if x[0][0] != ref_base_ch and x[1][0] != ref_base_ch:
        if x[2][1] == x[1][1] and x[2][0] == ref_base_ch:
            return x[0][0], x[0][1], x[2][0], x[2][1]
        if x[3][1] == x[1][1] and x[3][0] == ref_base_ch:
            return x[0][0], x[0][1], x[3][0], x[3][1]
    return x[0][0], x[0][1], x[1][0], x[1][1]


def scalar_candidates(pileup, qual_lists, cfg, exon_mask=None):
    """Returns list of dicts (one per candidate, pre-dense-filter) mirroring
    the CandidateSNP fields set in candidate.rs, and the index lists."""
    region = pileup.region
    out = []
    het_snps, homo_snps, edit_snps, somatic_snps = [], [], [], []
    position = region.start - 1
    P = pileup.length
    for col in range(P):
        pos = position
        position += 1  # emulate `position += 1` at each continue
        if exon_mask is not None and not exon_mask[col]:
            continue
        cnt4 = pileup.cnt[col]
        cov = int(cnt4.sum())
        if cov < cfg.min_depth or cov > cfg.max_depth:
            continue
        ref_ch = chr(pileup.ref_base[col])
        a1, c1, a2, c2 = get_two_major_alleles(cnt4, ref_ch)
        f1 = np.float32(c1) / np.float32(cov)
        f2 = np.float32(c2) / np.float32(cov)
        if a1 == ref_ch:
            alt_num, alt = 1, [(a2, f2, c2)]
        elif a2 == ref_ch:
            alt_num, alt = 1, [(a1, f1, c1)]
        else:
            alt_num, alt = 2, [(a1, f1, c1), (a2, f2, c2)]
        ref_allele_base = ref_ch if alt_num == 2 else (a1 if a1 == ref_ch else a2)
        if ref_allele_base not in "ACGTacgt":
            continue
        if alt_num == 1:
            if cov < 200 and alt[0][1] < np.float32(cfg.low_allele_frac_cutoff):
                continue
            if cov >= 200 and alt[0][2] < cfg.low_allele_cnt_cutoff:
                continue
        if pileup.n_del[col] >= alt[0][2]:
            continue
        dii = cov + int(pileup.n_del[col]) + int(pileup.n_intron[col])
        if np.float32(c1 + c2) / np.float32(dii) < np.float32(cfg.min_allele_freq_include_intron):
            continue
        # baseq pass
        def bq_list(allele_ch):
            ai = ACGT.index(allele_ch)
            return qual_lists.get((col, ai), [])
        if a1 != ref_ch:
            if c1 > 0 and sum(1 for q in bq_list(a1) if q >= cfg.min_baseq) < 2:
                continue
        elif a2 != ref_ch:
            if c2 > 0 and sum(1 for q in bq_list(a2) if q >= cfg.min_baseq) < 2:
                continue
        if cfg.strand_bias:
            def strands(allele_ch):
                ai = ACGT.index(allele_ch.upper())
                return int(pileup.strands[col, ai, 0]), int(pileup.strands[col, ai, 1])
            rf, rr = strands(ref_allele_base)
            if alt_num == 1:
                af, ar = strands(alt[0][0])
                sor = cal_strand_odds_ratio(rf, rr, af, ar)
            else:
                af1_, ar1_ = strands(alt[0][0])
                af2_, ar2_ = strands(alt[1][0])
                sor = max(cal_strand_odds_ratio(rf, rr, af1_, ar1_),
                          cal_strand_odds_ratio(rf, rr, af2_, ar2_))
            if sor > SOR_THRESHOLD:
                continue
            if alt_num == 1:
                af, ar = strands(alt[0][0])
                if af + ar <= 30:
                    if binomial_two_tailed(af, af + ar) < 0.05:
                        continue
                if af * ar == 0:
                    continue
        # genotype likelihood (per-base, reference order: ref list first,
        # then the three non-ref allele lists in fixed order)
        if ref_ch == "A":
            ident, diff = 0, [1, 2, 3]
        elif ref_ch == "C":
            ident, diff = 1, [0, 2, 3]
        elif ref_ch == "G":
            ident, diff = 2, [0, 1, 3]
        elif ref_ch == "T":
            ident, diff = 3, [0, 1, 2]
        else:
            continue  # 'N' or lowercase: "unknown ref base"
        ll = [0.0, 0.0, 0.0]
        for q in qual_lists.get((col, ident), []):
            e = 0.1 ** (q / 10.0)
            ll[0] += math.log10(e)
            ll[2] += math.log10(1.0 - e)
        for d in diff:
            for q in qual_lists.get((col, d), []):
                e = 0.1 ** (q / 10.0)
                ll[0] += math.log10(1.0 - e)
                ll[2] += math.log10(e)
        ll[1] = -cov * math.log10(2.0)
        bg = [THETA / 2.0, THETA, 1.0 - 1.5 * THETA]
        lp = [ll[i] + math.log10(bg[i]) for i in range(3)]
        m = max(lp)
        vp = [10.0 ** (x - m) for x in lp]
        s = sum(vp)
        vp = [x / s for x in vp]
        variant_quality = -10.0 * math.log10(max(1e-300, vp[2]))
        m2 = max(ll)
        gp = [10.0 ** (x - m2) for x in ll]
        s2 = sum(gp)
        gp = [x / s2 for x in gp]
        phred = sorted(-10.0 * math.log10(x) if x > 0 else float("inf") for x in gp)
        genotype_quality = phred[1] - phred[0]
        if gp[0] > gp[1] and gp[0] > gp[2]:
            vt, geno = 2, -1
        elif gp[1] > gp[0] and gp[1] > gp[2]:
            vt, geno = 1, 0
        else:
            vt, geno = 0, 1
        if variant_quality < cfg.min_qual:
            continue
        snp = dict(pos=pos, alleles=(a1, a2), allele_freqs=(f1, f2),
                   reference=ref_ch, depth=cov, variant_quality=variant_quality,
                   genotype_prob=gp, genotype_quality=genotype_quality,
                   variant_type=vt, genotype=geno,
                   rna_editing=False, cand_somatic=False, dense=False,
                   hom_var=False, het_var=False, for_phasing=False)
        tsf, tsr = int(pileup.ts[col, 0]), int(pileup.ts[col, 1])
        alt0 = alt[0][0]
        if (ref_allele_base == "A" and alt0 == "G"
                and (tsf > tsr * 2 or (tsf == 0 and tsr == 0)) and vt != 2):
            snp["rna_editing"] = True
            out.append(snp)
            edit_snps.append(len(out) - 1)
            continue
        if (ref_allele_base == "T" and alt0 == "C"
                and (tsr > tsf * 2 or (tsf == 0 and tsr == 0)) and vt != 2):
            snp["rna_editing"] = True
            out.append(snp)
            edit_snps.append(len(out) - 1)
            continue
        if alt_num == 1 and alt[0][1] < np.float32(cfg.min_allele_freq):
            snp["cand_somatic"] = True
            out.append(snp)
            somatic_snps.append(len(out) - 1)
            continue
        if vt == 2:
            if (alt_num == 2 and alt[0][1] >= np.float32(cfg.min_allele_freq)
                    and alt[1][1] >= np.float32(cfg.min_allele_freq)):
                snp["variant_type"] = 3
                snp["genotype"] = -1
            snp["hom_var"] = True
            snp["for_phasing"] = True
            out.append(snp)
            homo_snps.append(len(out) - 1)
            continue
        if vt == 1:
            if alt_num == 2:
                snp["variant_type"] = 3
                snp["genotype"] = -1
                snp["hom_var"] = True
                snp["for_phasing"] = True
                out.append(snp)
                homo_snps.append(len(out) - 1)
                continue
            snp["het_var"] = True
            snp["for_phasing"] = True
            out.append(snp)
            het_snps.append(len(out) - 1)
            continue
        # vt == 0: no record
    return out, dict(het=het_snps, hom=homo_snps, edit=edit_snps,
                     somatic=somatic_snps)


def apply_dense_filters(out, het_snps, homo_snps, win, min_cnt):
    concat = sorted(homo_snps + het_snps)
    n = len(concat)
    for i in range(n):
        start = out[concat[i]]["pos"]
        for j in range(i, n):
            diff = out[concat[j]]["pos"] - start
            if diff > win:
                if (j - i) >= min_cnt:
                    for tk in range(i, j):
                        out[concat[tk]]["dense"] = True
                        out[concat[tk]]["for_phasing"] = False
                break
            if j == n - 1 and (j - i + 1) >= min_cnt:
                for tk in range(i, j):
                    out[concat[tk]]["dense"] = True
                    out[concat[tk]]["for_phasing"] = False
    for i in range(n):
        start = out[concat[i]]["pos"]
        for j in range(i, n):
            diff = out[concat[j]]["pos"] - start
            if diff >= 5:
                if (j - i) >= 3:
                    for tk in range(i, j):
                        out[concat[tk]]["dense"] = True
                        out[concat[tk]]["for_phasing"] = False
                break
            if j == n - 1 and (j - i + 1) >= 3:
                for tk in range(i, j):
                    out[concat[tk]]["dense"] = True
                    out[concat[tk]]["for_phasing"] = False


def dense_mask_scalar(pos, win, min_cnt, strict):
    """Literal transcription of one dense-window scan (candidate.rs:471-497):
    the comparison oracle for the vectorised ops.candidates.dense_mask."""
    import numpy as np
    n = len(pos)
    dense = np.zeros(n, dtype=bool)
    for i in range(n):
        start = pos[i]
        for j in range(i, n):
            diff = pos[j] - start
            over = diff > win if strict else diff >= win
            if over:
                if (j - i) >= min_cnt:
                    dense[i:j] = True
                break
            if j == n - 1 and (j - i + 1) >= min_cnt:
                dense[i:j] = True
    return dense
