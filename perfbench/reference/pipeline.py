"""Frozen copy of ``tests/oracle_pipeline.py`` at commit
fbeccaa9682300b9b3ab6ff3e33e50e6f6928b91: a literal, slow transcription of
the upstream per-region closure (longcallR/src/thread.rs:77-222), composed
from the per-stage transcriptions beside it (pileup, candidates, phase
probabilities) and its own fragments, LD blocks, phase, read assignment,
rescue, phase sets and VCF emission.

Changes from the original: ``TIE_TOL`` is the program's default written out
(the original imports it from the JAX package); the perturbation schedule
draws its randoms with ``rng.py`` (the bits of ``jax.random``) in place of
``jax.random``; the per-stage modules are imported from this package; and
the two sums of ``scalar_cross_optimize`` that fed only an ``assert`` are
left out.
"""

import math

import numpy as np

from . import rng as R
from .candidates import apply_dense_filters, scalar_candidates
from .phase import (aki, cal_delta_eta_sigma_log, cal_phase_score_log,
                    cal_sigma_delta_eta_log)
from .pileup import scalar_pileup

# the program's tie quantum of a decision (LONGCALLR_TIE_TOL's default)
TIE_TOL = 1e-9


# ---------------------------------------------------------------------------
# Scalar state objects (snp.rs CandidateSNP / Fragment / FragElem)
# ---------------------------------------------------------------------------

class OSNP:
    """CandidateSNP fields used by the pipeline (snp.rs:20-120)."""

    def __init__(self, d):
        self.pos = d["pos"]
        self.reference = d["reference"]          # ref base char
        self.alleles = list(d["alleles"])        # two chars
        self.allele_freqs = list(d["allele_freqs"])  # two f32
        self.depth = d["depth"]
        self.variant_quality = d["variant_quality"]
        self.genotype_quality = d["genotype_quality"]
        self.variant_type = d["variant_type"]
        self.genotype = d["genotype"]
        self.haplotype = 0
        self.dense = d["dense"]
        self.rna_editing = d["rna_editing"]
        self.cand_somatic = d["cand_somatic"]
        self.hom_var = d["hom_var"]
        self.het_var = d["het_var"]
        self.for_phasing = d["for_phasing"]
        self.single = False
        self.non_selected = False
        self.phase_score = 0.0
        self.phase_set = 0
        self.snp_cover_fragments = []


class OFragElem:
    __slots__ = ("snp_idx", "pos", "base", "baseq", "prob", "p", "phase_site")

    def __init__(self, snp_idx, pos, base, baseq, prob, p, phase_site):
        self.snp_idx = snp_idx
        self.pos = pos
        self.base = base
        self.baseq = baseq
        self.prob = prob
        self.p = p
        self.phase_site = phase_site


class OFrag:
    __slots__ = ("read_id", "list", "haplotag", "assignment",
                 "assignment_score", "num_hete_links", "for_phasing",
                 "downsampled")

    def __init__(self, read_id):
        self.read_id = read_id
        self.list = []
        self.haplotag = 0
        self.assignment = 0
        self.assignment_score = 0.0
        self.num_hete_links = 0
        self.for_phasing = False
        self.downsampled = True


# ---------------------------------------------------------------------------
# Fragments (fragment.rs:10-305)
# ---------------------------------------------------------------------------

def scalar_get_fragments(bam, region, ref_seq, snps, cfg):
    """Literal CIGAR walk over the second BAM pass. Returns (frags,
    allele_pairs) where allele_pairs[(i1, i2)] is a dict of base-char pair
    counts ([b1, b2] → n) exactly as the reference's LD_Pair.ld_pairs."""
    frags = []
    allele_pairs = {}
    if len(snps) == 0:
        return frags, allele_pairs
    last_pos = snps[-1].pos
    first_pos = snps[0].pos
    for r in bam.fetch(region.chr, region.start, region.end):
        if (r.mapq < cfg.min_mapq or r.l_seq < cfg.min_read_length
                or r.is_unmapped or r.is_secondary or r.is_supplementary):
            continue
        de = r.get_tag("de")
        if isinstance(de, float) and de >= cfg.divergence:
            continue
        pos = r.pos
        if pos > last_pos:
            continue
        seq = r.seq
        qual = r.qual
        pos_on_ref = pos
        pos_on_query = r.leading_softclips()
        idx = 0
        if pos <= first_pos:
            snp_pos = snps[idx].pos
            alleles = list(snps[idx].alleles)
        else:
            while idx < len(snps):
                if snps[idx].pos >= pos:
                    break
                idx += 1
            assert idx < len(snps)
            snp_pos = snps[idx].pos
            alleles = list(snps[idx].alleles)

        frag = OFrag(r.qname)
        frag_idx = len(frags)
        ops = r.cigar_ops.tolist()
        lens = r.cigar_lens.tolist()
        for op, ln in zip(ops, lens):
            ch = "MIDNSHP=X"[op]
            if ch in "SH":
                continue
            if ch in "M=X":
                for _ in range(ln):
                    if pos_on_ref == snp_pos:
                        base = chr(seq[pos_on_query])
                        bq = int(qual[pos_on_query])
                        if bq >= 30:
                            bq = 30          # fragment.rs:127-131 cap
                        prob = 10.0 ** (-float(bq) / 10.0)
                        if base == snps[idx].reference:
                            p = 1
                        elif (base in (alleles[0], alleles[1])
                              and base != snps[idx].reference):
                            p = -1
                        else:
                            p = 0
                        phase_site = bool(snps[idx].for_phasing)
                        if not snps[idx].dense and p != 0:
                            frag.list.append(OFragElem(
                                idx, pos_on_ref, base, bq, prob, p,
                                phase_site))
                        idx += 1
                        if idx < len(snps):
                            snp_pos = snps[idx].pos
                            alleles = list(snps[idx].alleles)
                    pos_on_query += 1
                    pos_on_ref += 1
            elif ch == "I":
                pos_on_query += ln
            elif ch in "DN":
                for _ in range(ln):
                    if pos_on_ref == snp_pos:
                        idx += 1
                        if idx < len(snps):
                            snp_pos = snps[idx].pos
                            alleles = list(snps[idx].alleles)
                    pos_on_ref += 1
            else:
                raise ValueError(ch)

        # pairwise LD counts over the kept cells (fragment.rs:208-240)
        fl = frag.list
        for i in range(len(fl)):
            for j in range(i + 1, len(fl)):
                if fl[i].snp_idx < fl[j].snp_idx:
                    k1, k2 = fl[i].snp_idx, fl[j].snp_idx
                    b1, b2 = fl[i].base, fl[j].base
                else:
                    k1, k2 = fl[j].snp_idx, fl[i].snp_idx
                    b1, b2 = fl[j].base, fl[i].base
                tbl = allele_pairs.setdefault((k1, k2), {})
                tbl[(b1, b2)] = tbl.get((b1, b2), 0) + 1

        hete_links = sum(1 for fe in fl if fe.phase_site)
        frag.num_hete_links = hete_links
        assert cfg.min_linkers > 0
        frag.for_phasing = hete_links >= cfg.min_linkers
        for fe in fl:
            snps[fe.snp_idx].snp_cover_fragments.append(frag_idx)
        frags.append(frag)
    return frags, allele_pairs


def scalar_downsample(frags, downsample_depth, seed):
    """phase.rs:693-701 with the repo's fixed-seed numpy convention
    (phasing/fragments.py:340-348)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(frags))[:downsample_depth]
    for f in frags:
        f.downsampled = False
    for i in idx:
        frags[int(i)].downsampled = True


# ---------------------------------------------------------------------------
# LD blocks (candidate.rs:615-747 + snp.rs:158-194)
# ---------------------------------------------------------------------------

def calculate_ld(tbl, A, a, B, b):
    """snp.rs:158-188: (score f32, weight i32) from base-pair counts."""
    c_ab = tbl.get((A, B), 0)
    c_aB = tbl.get((A, b), 0)
    c_Ab = tbl.get((a, B), 0)
    c_abab = tbl.get((a, b), 0)
    same = c_ab + c_abab
    opp = c_aB + c_Ab
    c1 = min(same, opp)
    c2 = max(same, opp)
    score = np.float32(c1) / np.float32(c2)  # NaN when c2 == 0
    if same > opp:
        return float(score), c2
    return float(-score), -c2


def divide_snps_into_blocks(snps, allele_pairs, ld_weight_threshold=1):
    """candidate.rs:615-747. Returns (pair_ld, adj, blocks):
    pair_ld[(i, j)] = (score, weight) for valid pairs; adj is the
    weight-filtered perfect-LD graph; blocks are its connected components
    (repo convention: ordered by min node, members sorted — the reference's
    kosaraju_scc order is unspecified)."""
    pair_ld = {}
    edges = {}
    nodes = set()
    ld_idxes = [i for i, s in enumerate(snps) if s.for_phasing]
    for ii in range(len(ld_idxes)):
        for jj in range(ii + 1, len(ld_idxes)):
            idx1, idx2 = ld_idxes[ii], ld_idxes[jj]
            s1, s2 = snps[idx1], snps[idx2]
            if s1.alleles[0] == s1.reference and s1.alleles[1] != s1.reference:
                r1, rf1, a1, af1 = (s1.alleles[0], s1.allele_freqs[0],
                                    s1.alleles[1], s1.allele_freqs[1])
            elif s1.alleles[0] != s1.reference and s1.alleles[1] == s1.reference:
                r1, rf1, a1, af1 = (s1.alleles[1], s1.allele_freqs[1],
                                    s1.alleles[0], s1.allele_freqs[0])
            else:
                continue
            if s2.alleles[0] == s2.reference and s2.alleles[1] != s2.reference:
                r2, rf2, a2, af2 = (s2.alleles[0], s2.allele_freqs[0],
                                    s2.alleles[1], s2.allele_freqs[1])
            elif s2.alleles[0] != s2.reference and s2.alleles[1] == s2.reference:
                r2, rf2, a2, af2 = (s2.alleles[1], s2.allele_freqs[1],
                                    s2.alleles[0], s2.allele_freqs[0])
            else:
                continue
            assert idx1 < idx2
            tbl = allele_pairs.get((idx1, idx2))
            if tbl is None:
                continue
            if rf1 == 0.0 or af1 == 0.0 or rf2 == 0.0 or af2 == 0.0:
                continue
            score, weight = calculate_ld(tbl, r1, a1, r2, a2)
            pair_ld[(idx1, idx2)] = (score, weight)
            if score == 0.0:                      # perfect LD; NaN fails
                edges[(idx1, idx2)] = weight
                nodes.add(idx1)
                nodes.add(idx2)
    adj = {n: [] for n in nodes}
    for (i, j), w in edges.items():
        if abs(w) >= ld_weight_threshold:
            adj[i].append(j)
            adj[j].append(i)
    for n in adj:
        adj[n].sort()
    blocks = []
    seen = set()
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
    return pair_ld, adj, blocks


# ---------------------------------------------------------------------------
# cross_optimize (phase.rs:810-976) — scalar, synchronous half-steps
# ---------------------------------------------------------------------------

def _cal_overall_probability(snps, frags, apply_ds):
    """phase.rs:257-276."""
    logp = 0.0
    for f in frags:
        if not f.for_phasing or (apply_ds and not f.downsampled) \
                or f.haplotag == 0:
            continue
        for fe in f.list:
            if not fe.phase_site:
                continue
            assert fe.p != 0
            logp += math.log10(aki(f.haplotag, snps[fe.snp_idx].haplotype,
                                   snps[fe.snp_idx].genotype, fe.p, fe.prob))
    return logp


def scalar_cross_optimize(snps, frags, conserved, keep_conserved,
                          with_genotype, apply_ds):
    """phase.rs:810-976, with check_new_haplotag /
    check_new_haplotype_genotype (phase.rs:278-355) accumulated in index
    order (the reference iterates HashMaps — nondeterministic)."""
    hap_geno_increase = True
    haplotag_increase = True
    num_iters = 0
    while hap_geno_increase | haplotag_increase:
        # -- optimize sigma (phase.rs:823-869)
        tmp_haplotag = {}
        for k, f in enumerate(frags):
            if not f.for_phasing or (apply_ds and not f.downsampled) \
                    or f.haplotag == 0:
                continue
            sigma_k = f.haplotag
            delta, eta, ps, probs = [], [], [], []
            for fe in f.list:
                if not fe.phase_site:
                    continue
                assert fe.p != 0
                ps.append(fe.p)
                probs.append(fe.prob)
                delta.append(snps[fe.snp_idx].haplotype)
                eta.append(snps[fe.snp_idx].genotype)
            if not delta:
                continue
            q = cal_sigma_delta_eta_log(sigma_k, delta, eta, ps, probs)
            qn = cal_sigma_delta_eta_log(-sigma_k, delta, eta, ps, probs)
            # tie-quantized flip (kernels.TIE_TOL): keep current sigma at a
            # structural tie — same rule as the production kernels
            tmp_haplotag[k] = -sigma_k if qn > q + TIE_TOL else sigma_k
        changed_any = any(tmp_haplotag[k] != frags[k].haplotag
                          for k in tmp_haplotag)
        for k, h in tmp_haplotag.items():
            frags[k].haplotag = h
        # exact per-element continue flag (order-independent; a flip implies
        # a > TIE_TOL improvement, so this equals the reference's strict
        # sum test in exact arithmetic)
        haplotag_increase = changed_any
        if haplotag_increase:
            hap_geno_increase = True

        # -- optimize delta/eta (phase.rs:871-965)
        tmp_hap_geno = {}
        for i, s in enumerate(snps):
            if not s.for_phasing:
                continue
            if keep_conserved and i in conserved:
                continue
            delta_i = s.haplotype
            eta_i = s.genotype
            sigma, ps, probs = [], [], []
            for k in s.snp_cover_fragments:
                f = frags[k]
                if not f.for_phasing or (apply_ds and not f.downsampled) \
                        or f.haplotag == 0:
                    continue
                for fe in f.list:
                    if fe.snp_idx == i:
                        if not fe.phase_site:
                            continue
                        assert fe.p != 0
                        ps.append(fe.p)
                        probs.append(fe.prob)
                        sigma.append(f.haplotag)
            if not sigma:
                continue
            q1 = cal_delta_eta_sigma_log(delta_i, 0, sigma, ps, probs)
            q2 = cal_delta_eta_sigma_log(-delta_i, 0, sigma, ps, probs)
            q3 = cal_delta_eta_sigma_log(delta_i, 1, sigma, ps, probs)
            q4 = cal_delta_eta_sigma_log(delta_i, -1, sigma, ps, probs)
            if with_genotype:
                mq = max(q1, max(q2, max(q3, q4)))
                # tie order q1 > q2 > q3 > q4, TIE_TOL-quantized
                if q1 >= mq - TIE_TOL:
                    tmp_hap_geno[i] = (delta_i, 0)
                elif q2 >= mq - TIE_TOL:
                    tmp_hap_geno[i] = (-delta_i, 0)
                elif q3 >= mq - TIE_TOL:
                    tmp_hap_geno[i] = (delta_i, 1)
                else:
                    tmp_hap_geno[i] = (delta_i, -1)
            else:
                if eta_i == 0:
                    tmp_hap_geno[i] = ((-delta_i, 0) if q2 > q1 + TIE_TOL
                                       else (delta_i, 0))
                else:
                    tmp_hap_geno[i] = ((delta_i, -1) if q4 > q3 + TIE_TOL
                                       else (delta_i, 1))
        changed_any = any(tmp_hap_geno[i] != (snps[i].haplotype,
                                              snps[i].genotype)
                          for i in tmp_hap_geno)
        for i, (d_new, e_new) in tmp_hap_geno.items():
            snps[i].haplotype = d_new
            snps[i].genotype = e_new
        hap_geno_inc = changed_any
        if hap_geno_inc:
            haplotag_increase = True
            hap_geno_increase = True
        else:
            hap_geno_increase = False

        num_iters += 1
        if num_iters > 20:
            break
    return _cal_overall_probability(snps, frags, apply_ds)


# ---------------------------------------------------------------------------
# phase (phase.rs:1087-1296) with the repo's fixed-seed conventions
# ---------------------------------------------------------------------------

def _bucket(n, lo=8):
    b = lo
    while b < n:
        b <<= 1
    return b


def _enumeration_order(n):
    """phase.rs:1099-1106."""
    configs = [[1] * n]
    for ti in range(n):
        for tj in range(len(configs)):
            c = list(configs[tj])
            c[ti] = -c[ti]
            configs.append(c)
    assert len(configs) == 2 ** n
    return configs


def _init_genotype(snps):
    """phase.rs:682-691."""
    for s in snps:
        if s.variant_type == 0:
            s.genotype = 1
        elif s.variant_type == 1:
            s.genotype = 0
        elif s.variant_type in (2, 3):
            s.genotype = -1


def _save_config(snps, frags):
    return ([s.haplotype for s in snps], [f.haplotag for f in frags],
            [s.genotype for s in snps])


def _load_config(snps, frags, cfg3):
    hap, tag, gen = cfg3
    for s, h, g in zip(snps, hap, gen):
        s.haplotype = h
        s.genotype = g
    for f, t in zip(frags, tag):
        f.haplotag = t


def _block_flip_pass(snps, frags, blocks, apply_ds):
    """The repo's deterministic replacement for cross_optimize_by_block
    (phase.rs:1298-1394; reference behaviour depends on HashMap iteration
    order — see PARITY.md): every block that improves its own objective
    flips, decisions computed against the current state and applied
    together (phasing/optimize.py:488-559)."""
    if not blocks:
        return
    block_of = {}
    for bid, comp in enumerate(blocks):
        for i in comp:
            block_of[i] = bid
    ds_ok = lambda f: (not apply_ds) or f.downsampled
    # block fully containing each active read (all of its cells in one block)
    full_in = []
    for f in frags:
        cells = {fe.snp_idx for fe in f.list}
        if cells and all(block_of.get(i) is not None
                         and block_of[i] == block_of[next(iter(cells))]
                         for i in cells):
            full_in.append(block_of[next(iter(cells))])
        else:
            full_in.append(-1)
    decisions = []
    for bid, comp in enumerate(blocks):
        q_cur = q_new = 0.0
        for i in comp:
            s = snps[i]
            if not s.for_phasing:
                continue
            sigma, sigma_f, ps, probs = [], [], [], []
            for k in s.snp_cover_fragments:
                f = frags[k]
                if not f.for_phasing or not ds_ok(f) or f.haplotag == 0:
                    continue
                for fe in f.list:
                    if fe.snp_idx == i and fe.phase_site:
                        ps.append(fe.p)
                        probs.append(fe.prob)
                        sigma.append(f.haplotag)
                        sigma_f.append(-f.haplotag if full_in[k] == bid
                                       else f.haplotag)
            if not sigma:
                continue
            q_cur += cal_delta_eta_sigma_log(s.haplotype, s.genotype,
                                             sigma, ps, probs)
            q_new += cal_delta_eta_sigma_log(-s.haplotype, s.genotype,
                                             sigma_f, ps, probs)
        if q_new > q_cur + TIE_TOL:
            decisions.append(bid)
    for bid in decisions:
        comp = blocks[bid]
        compset = set(comp)
        for i in comp:
            snps[i].haplotype = -snps[i].haplotype
        for k, f in enumerate(frags):
            if full_in[k] != bid:
                continue
            if not (f.for_phasing and ds_ok(f) and f.haplotag != 0):
                continue
            if any(fe.phase_site and fe.snp_idx in compset for fe in f.list):
                f.haplotag = -f.haplotag


def scalar_phase(snps, frags, allele_pairs, cfg, region_start, apply_ds):
    """phase.rs:1087-1296 with the repo's seeded-rng conventions
    (phasing/optimize.py:595-726): one SeedSequence stream per region,
    drawn in the identical order; jax.random drives the perturbation
    schedule exactly as perturbation_phase does."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, region_start & 0x7FFFFFFF]))
    K0, I0 = len(frags), len(snps)
    if I0 == 0:
        return
    K = _bucket(max(1, K0))
    I_pad = _bucket(max(1, I0))
    read_base = [f.for_phasing and ((not apply_ds) or f.downsampled)
                 for f in frags]

    pair_ld, adj, blocks = divide_snps_into_blocks(snps, allele_pairs)

    if I0 <= cfg.max_enum_snps:
        # enumeration (phase.rs:1097-1122); the repo draws the per-config
        # initial assignment as one (C, padded-K) block
        configs = _enumeration_order(I0)
        C = len(configs)
        draws = rng.random((C, K))
        best_prob = -math.inf
        best = None
        for c in range(C):
            for s, h in zip(snps, configs[c]):
                s.haplotype = h
            for k, f in enumerate(frags):
                f.haplotag = ((-1 if draws[c, k] < 0.5 else 1)
                              if read_base[k] else 0)
            _init_genotype(snps)
            prob = scalar_cross_optimize(snps, frags, set(), False, True,
                                         apply_ds)
            if prob > best_prob + TIE_TOL:   # tie-quantized keep-first
                best_prob = prob
                best = _save_config(snps, frags)
        _load_config(snps, frags, best)
        return

    # iterative (phase.rs:1123-1294)
    # init_haplotypes_LD2 (phase.rs:609-671): random ±1, then BFS-consistent
    # haplotypes inside each perfect-LD block
    draws = rng.random(I0)
    for i, s in enumerate(snps):
        s.haplotype = 1 if draws[i] < 0.5 else -1
    conserved = set()
    for comp in blocks:
        if len(comp) < 2:
            continue
        root = comp[0]
        snps[root].haplotype = 1
        visited = [root]
        vset = {root}
        queue = [root]
        order = []
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in adj.get(u, []):
                if v not in vset:
                    vset.add(v)
                    queue.append(v)
        for nx in order:
            if nx == root:
                continue
            for vi in visited:
                a, b = (vi, nx) if vi < nx else (nx, vi)
                sw = pair_ld.get((a, b))
                if sw is None or sw[0] != 0.0:
                    continue
                if sw[1] >= 1:
                    snps[nx].haplotype = snps[vi].haplotype
                    break
                if sw[1] <= -1:
                    snps[nx].haplotype = -snps[vi].haplotype
                    break
            visited.append(nx)
        for i in comp:
            conserved.add(i)
    _init_genotype(snps)
    draws = rng.random(K)
    for k, f in enumerate(frags):
        f.haplotag = (-1 if draws[k] < 0.5 else 1) if read_base[k] else 0

    best_prob = -math.inf
    best = None

    def consider():
        nonlocal best_prob, best
        if prob > best_prob + TIE_TOL:   # tie-quantized keep-best
            best_prob = prob
            best = _save_config(snps, frags)

    prob = scalar_cross_optimize(snps, frags, conserved, True, False, apply_ds)
    consider()
    _load_config(snps, frags, best)

    _block_flip_pass(snps, frags, blocks, apply_ds)
    prob = _cal_overall_probability(snps, frags, apply_ds)
    consider()
    _load_config(snps, frags, best)

    # perturbation schedule (phase.rs:1198-1233) — same jax.random stream as
    # optimize.perturbation_phase (fold_in per round, split, padded shapes)
    n_rounds = I0 // 4 + 1
    key = R.prng_key(
        int(rng.integers(0, np.iinfo(np.int64).max, dtype=np.int64)))
    for tidx in range(n_rounds):
        kr = R.fold_in(key, tidx)
        k1, k2 = R.split(kr)
        flip = tidx % 2 == 1
        lowv = 1 if flip else -1
        rg = R.uniform(k1, I_pad)
        for i, s in enumerate(snps):
            if rg[i] < 0.1:
                s.haplotype = lowv
            elif rg[i] >= 0.9:
                s.haplotype = -lowv
        prob = scalar_cross_optimize(snps, frags, conserved, False, False,
                                     apply_ds)
        consider()
        _load_config(snps, frags, best)
        fl = R.uniform(k2, K)
        for k, f in enumerate(frags):
            if fl[k] < 0.1 and read_base[k] and f.haplotag != 0:
                f.haplotag = -f.haplotag
        prob = scalar_cross_optimize(snps, frags, conserved, False, False,
                                     apply_ds)
        consider()
        _load_config(snps, frags, best)


# ---------------------------------------------------------------------------
# assignment / rescue / phase sets (snpfrags.rs:191-733)
# ---------------------------------------------------------------------------

def scalar_assign_reads(snps, frags, cutoff, apply_ds):
    """snpfrags.rs:548-625 (incl. the sticky fe.phase_site promotion)."""
    out = {}
    for f in frags:
        if not f.for_phasing or (apply_ds and not f.downsampled):
            continue
        sigma_k = f.haplotag
        delta, eta, ps, probs = [], [], [], []
        for fe in f.list:
            if not fe.phase_site and snps[fe.snp_idx].for_phasing:
                fe.phase_site = True
            if not snps[fe.snp_idx].for_phasing:
                continue
            if snps[fe.snp_idx].haplotype == 0:
                continue
            if snps[fe.snp_idx].genotype != 0:
                continue
            assert fe.p != 0
            ps.append(fe.p)
            probs.append(fe.prob)
            delta.append(snps[fe.snp_idx].haplotype)
            eta.append(snps[fe.snp_idx].genotype)
        if sigma_k == 0 or not delta:
            f.assignment = 0
            f.haplotag = 0
            f.assignment_score = 0.0
            out[f.read_id] = 0
            continue
        q = cal_sigma_delta_eta_log(sigma_k, delta, eta, ps, probs)
        qn = cal_sigma_delta_eta_log(-sigma_k, delta, eta, ps, probs)
        if abs(q - qn) >= cutoff:
            if q >= qn:
                f.assignment = 1 if sigma_k == 1 else 2
                f.assignment_score = q
            else:
                f.assignment = 2 if sigma_k == 1 else 1
                f.assignment_score = qn
                f.haplotag = -sigma_k
            out[f.read_id] = f.assignment
        else:
            f.assignment = 0
            f.haplotag = 0
            f.assignment_score = 0.0
            out[f.read_id] = 0
    return out


PHASE_SCORE_SENTINEL = 0.19940219  # snpfrags.rs:486


def scalar_assign_snp(snps, frags, min_linkers, apply_ds):
    """snpfrags.rs:378-546."""
    for ti, s in enumerate(snps):
        if not s.for_phasing:
            s.non_selected = True
            continue
        if not s.snp_cover_fragments:
            s.single = True
            continue
        delta_i = s.haplotype
        sigma, ps, probs = [], [], []
        h1 = h2 = 0
        for k in s.snp_cover_fragments:
            f = frags[k]
            if not f.for_phasing or f.num_hete_links < min_linkers:
                continue
            if apply_ds and not f.downsampled:
                continue
            if s.variant_type == 1 and f.assignment == 0:
                continue
            for fe in f.list:
                if fe.snp_idx == ti:
                    if fe.base != "-":
                        if f.assignment == 1:
                            h1 += 1
                        elif f.assignment == 2:
                            h2 += 1
                    assert fe.phase_site
                    assert fe.p != 0
                    ps.append(fe.p)
                    probs.append(fe.prob)
                    sigma.append(f.haplotag)
        if not sigma:
            s.non_selected = True
            continue
        q1 = cal_delta_eta_sigma_log(delta_i, 0, sigma, ps, probs)
        q2 = cal_delta_eta_sigma_log(-delta_i, 0, sigma, ps, probs)
        q3 = cal_delta_eta_sigma_log(delta_i, 1, sigma, ps, probs)
        q4 = cal_delta_eta_sigma_log(delta_i, -1, sigma, ps, probs)
        mq = max(q1, max(q2, max(q3, q4)))
        if q1 == mq:
            s.haplotype = delta_i
            s.genotype = 0
            s.variant_type = 1
        elif q2 == mq:
            s.haplotype = -delta_i
            s.genotype = 0
            s.variant_type = 1
        elif q3 == mq:
            s.haplotype = delta_i
            s.genotype = 1
            s.variant_type = 0
        else:
            s.haplotype = delta_i
            s.genotype = -1
            if s.variant_type not in (2, 3):
                s.variant_type = 2
        if s.genotype != 0:
            s.non_selected = True
            continue
        if sigma and h1 >= 1 and h2 >= 1:
            q = cal_phase_score_log(s.haplotype, s.genotype, sigma, ps, probs)
            s.phase_score = -10.0 * math.log10(1.0 - q)
        else:
            s.phase_score = PHASE_SCORE_SENTINEL


def scalar_eval_rescue(snps, frags, idx_list, min_phase_score, min_linkers,
                       apply_ds, rng, kind):
    """eval_rna_edit_var_phase (snpfrags.rs:191-281) when kind == 'edit';
    eval_low_frac_var_phase (snpfrags.rs:283-376) when kind == 'somatic'.
    Unassigned covering reads of a rescued site draw a fresh haplotag from
    the repo's seeded rng (the reference uses thread_rng)."""
    for ti in idx_list:
        s = snps[ti]
        if not s.snp_cover_fragments:
            s.single = True
            continue
        if s.variant_type != 1:
            s.non_selected = True
            continue
        sigma, ps, probs = [], [], []
        h1 = h2 = 0
        for k in s.snp_cover_fragments:
            f = frags[k]
            if not f.for_phasing or f.assignment == 0 \
                    or f.num_hete_links < min_linkers:
                continue
            if apply_ds and not f.downsampled:
                continue
            for fe in f.list:
                if fe.snp_idx == ti:
                    if fe.base != "-":
                        if f.assignment == 1:
                            h1 += 1
                        elif f.assignment == 2:
                            h2 += 1
                    assert fe.p != 0
                    ps.append(fe.p)
                    probs.append(fe.prob)
                    sigma.append(f.haplotag)
        if not sigma or h1 < 2 or h2 < 2:
            s.single = True
            continue
        s.single = False
        ps1 = -10.0 * math.log10(
            1.0 - cal_phase_score_log(1, 0, sigma, ps, probs))
        ps2 = -10.0 * math.log10(
            1.0 - cal_phase_score_log(-1, 0, sigma, ps, probs))
        if max(ps1, ps2) >= min_phase_score:
            s.non_selected = False
            s.rna_editing = False
            if kind == "somatic":
                s.cand_somatic = False
            s.for_phasing = True
            for k in s.snp_cover_fragments:
                f = frags[k]
                f.for_phasing = True
                if f.haplotag == 0 or f.assignment == 0:
                    f.haplotag = -1 if rng.random() < 0.5 else 1
            s.haplotype = 1 if ps1 >= ps2 else -1
            s.genotype = 0
            s.variant_type = 1
            s.phase_score = max(ps1, ps2)
        else:
            s.non_selected = True
            if kind == "edit":
                s.rna_editing = True
            else:
                s.cand_somatic = True
                s.for_phasing = False


def scalar_assign_phase_set(snps, frags, min_phase_score):
    """snpfrags.rs:628-733 with the repo's deterministic conventions
    (phasing/assign.py:357-432): PS id = 1-based position of the
    smallest-position component member; each read inherits the PS of its
    lexicographically smallest consistent node pair, first-wins."""
    I = len(snps)
    node = [s.genotype == 0 and s.variant_type == 1 and not s.dense
            and not s.rna_editing and s.phase_score >= min_phase_score
            for s in snps]
    nodes = [i for i in range(I) if node[i]]
    phase_sets = {}
    if not nodes:
        return phase_sets
    parent = {i: i for i in nodes}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    read_keys = []    # (key, read order) for tagged reads
    maxkey = None
    for k, f in enumerate(frags):
        if not f.for_phasing or f.assignment == 0:
            continue
        cells = [(fe.snp_idx, fe.p) for fe in f.list if node[fe.snp_idx]]
        if len(cells) == 1:
            i0 = cells[0][0]
            read_keys.append((i0 * I + i0, k))
        elif len(cells) >= 2:
            best_key = None
            for a in range(len(cells)):
                for b in range(a + 1, len(cells)):
                    ci, pi = cells[a]
                    cj, pj = cells[b]
                    if snps[ci].haplotype * snps[cj].haplotype != pi * pj:
                        continue
                    union(ci, cj)
                    key = ci * I + cj
                    if best_key is None or key < best_key:
                        best_key = key
            if best_key is not None:
                read_keys.append((best_key, k))
    comp = {}
    for i in nodes:
        comp.setdefault(find(i), []).append(i)
    node_ps = {}
    for root in sorted(comp):
        members = comp[root]
        ps_id = snps[min(members)].pos + 1
        for i in members:
            snps[i].phase_set = ps_id
            node_ps[i] = ps_id
    for key, k in sorted(read_keys):
        phase_sets.setdefault(frags[k].read_id, node_ps[key // I])
    return phase_sets


# ---------------------------------------------------------------------------
# VCF emission (vcf.rs:27-306 + the writer loop thread.rs:265-304)
# ---------------------------------------------------------------------------

def _as_i32(x):
    """Rust `f64 as i32` (truncate toward zero, saturating, NaN → 0)."""
    if math.isnan(x):
        return 0
    if x >= 2147483647.0:
        return 2147483647
    if x <= -2147483648.0:
        return -2147483648
    return int(x)


def _f2(x):
    return f"{float(x):.2f}"


def scalar_output_vcf(snps, chrom, min_phase_score):
    lines = []

    def emit(pos1, refb, alt, qual, filt, info, fmt, sample):
        if alt:  # thread.rs:265-304 only serialises records with ALT
            lines.append("\t".join([chrom, str(pos1), ".", refb, alt,
                                    str(qual), filt, info, fmt, sample]))

    for s in snps:
        pos1 = s.pos + 1
        refb = s.reference
        qual = _as_i32(float(s.variant_quality))
        gq = _as_i32(float(s.genotype_quality))

        def alt_single():
            if s.alleles[0] != s.reference:
                return s.alleles[0], s.allele_freqs[0]
            if s.alleles[1] != s.reference:
                return s.alleles[1], s.allele_freqs[1]
            return "", 0.0

        if s.dense:
            if s.variant_type in (1, 2):
                alt, af0 = alt_single()
                af1 = None
            elif s.variant_type == 3:
                alt = f"{s.alleles[0]},{s.alleles[1]}"
                af0, af1 = s.allele_freqs
            else:
                alt, af0, af1 = "", 0.0, None
            if s.variant_type == 1:
                gt = "0/1"
            elif s.variant_type == 2:
                gt = "1/1"
            elif s.variant_type == 3:
                gt = "1/2"
            else:
                continue
            if s.variant_type == 3:
                sample = f"{gt}:{gq}:{s.depth}:{_f2(af0)},{_f2(af1)}"
            else:
                sample = f"{gt}:{gq}:{s.depth}:{_f2(af0)}"
            emit(pos1, refb, alt, qual, "dn", "RDS=dense_snp",
                 "GT:GQ:DP:AF", sample)
            continue

        if s.non_selected:
            if s.rna_editing:
                if s.variant_type in (1, 2):
                    alt, af0 = alt_single()
                else:
                    continue
                gt = "0/1" if s.variant_type == 1 else "1/1"
                sample = f"{gt}:{gq}:{s.depth}:{_f2(af0)}"
                emit(pos1, refb, alt, qual, "RnaEdit", "RDS=noselect",
                     "GT:GQ:DP:AF", sample)
                continue
            two = False
            if s.variant_type in (0, 1, 2):
                alt, af0 = alt_single()
                if s.variant_type == 0:
                    gt, filt = "0/0", "HomRef"
                elif s.variant_type == 1:
                    gt, filt = "0/1", "LowQual"
                else:
                    gt, filt = "1/1", "PASS"
            else:
                if s.genotype in (-1, 1):
                    alt, af0 = alt_single()
                    gt, filt = (("1/1", "PASS") if s.genotype == -1
                                else ("0/0", "HomRef"))
                elif s.genotype == 0:
                    alt = f"{s.alleles[0]},{s.alleles[1]}"
                    af0, af1 = s.allele_freqs
                    gt, filt = "1/2", "Multiallelic"
                    two = True
                else:
                    alt, gt, filt, af0 = "", "0/0", "", 0.0
            if two:
                sample = f"{gt}:{gq}:{s.depth}:{_f2(af0)},{_f2(af1)}"
            else:
                sample = f"{gt}:{gq}:{s.depth}:{_f2(af0)}"
            emit(pos1, refb, alt, qual, filt, "RDS=noselect",
                 "GT:GQ:DP:AF", sample)
            continue

        gt, filt, alt = "0/0", "", ""
        af0, af1 = 0.0, None
        two = False
        if s.phase_score >= min_phase_score:
            if s.variant_type == 1:
                alt, af0 = alt_single()
                gt = "0|1" if s.haplotype == 1 else "1|0"
                filt = "PASS"
        else:
            if s.variant_type == 0:
                alt, af0 = alt_single()
                gt, filt = "0/0", "HomRef"
            elif s.variant_type == 1:
                alt, af0 = alt_single()
                gt, filt = "0/1", "LowQual"
            elif s.variant_type == 2:
                alt, af0 = alt_single()
                gt, filt = "1/1", "PASS"
            else:
                if s.genotype in (-1, 1):
                    alt, af0 = alt_single()
                    gt, filt = (("1/1", "PASS") if s.genotype == -1
                                else ("0/0", "HomRef"))
                elif s.genotype == 0:
                    alt = f"{s.alleles[0]},{s.alleles[1]}"
                    af0, af1 = s.allele_freqs
                    gt, filt = "1/2", "Multiallelic"
                    two = True
        ps_field = str(s.phase_set) if s.phase_set != 0 else "."
        if gt in ("0/0", "0/1", "1/1", "0|1", "1|0"):
            sample = f"{gt}:{gq}:{ps_field}:{s.depth}:{_f2(af0)}:{_f2(s.phase_score)}"
        else:
            sample = (f"{gt}:{gq}:{ps_field}:{s.depth}:"
                      f"{_f2(af0)},{_f2(af1)}:{_f2(s.phase_score)}")
        emit(pos1, refb, alt, qual, filt, "RDS=select",
             "GT:GQ:PS:DP:AF:PQ", sample)
    return lines


# ---------------------------------------------------------------------------
# The per-region closure (thread.rs:77-222)
# ---------------------------------------------------------------------------

def scalar_process_region(bam, region, ref_seq, cfg,
                          input_candidates=None, exon_mask=None):
    """Returns (vcf_lines, read_assignments, phase_sets) for one region,
    exactly as the fast pipeline's RegionResult carries them. Covers the
    -v wiring (input_candidates: chr → pos0 → GenotypeAndQuality — skips
    discovery AND the dense filters) and the --exon-only wiring
    (exon_mask: per-column bool over the region)."""
    qual_lists = {}
    pileup = scalar_pileup(bam, region, ref_seq, cfg, qual_lists)
    if input_candidates is not None:
        chr_cands = input_candidates.get(region.chr, {})
        out = scalar_import_candidates(pileup, ref_seq, chr_cands)
        idx = dict(het=[], hom=[], edit=[], somatic=[])
    else:
        out, idx = scalar_candidates(pileup, qual_lists, cfg,
                                     exon_mask=exon_mask)
        apply_dense_filters(out, idx["het"], idx["hom"],
                            cfg.dense_win_size, cfg.min_dense_cnt)
    snps = [OSNP(d) for d in out]
    edit_snps = idx["edit"]
    somatic_snps = idx["somatic"]

    frags, allele_pairs = scalar_get_fragments(bam, region, ref_seq, snps, cfg)
    apply_ds = (cfg.downsample and cfg.downsample_depth > 0
                and len(frags) >= cfg.downsample_depth)
    if apply_ds:
        scalar_downsample(frags, cfg.downsample_depth, 2025)

    scalar_phase(snps, frags, allele_pairs, cfg, region.start, apply_ds)

    rng7 = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, region.start & 0x7FFFFFFF, 7]))
    cutoff = cfg.min_read_assignment_diff
    scalar_assign_reads(snps, frags, cutoff, apply_ds)
    scalar_assign_snp(snps, frags, cfg.min_linkers, apply_ds)
    scalar_assign_reads(snps, frags, cutoff, apply_ds)
    scalar_assign_snp(snps, frags, cfg.min_linkers, apply_ds)
    scalar_eval_rescue(snps, frags, edit_snps, cfg.min_phase_score - 3.0,
                       cfg.min_linkers, apply_ds, rng7, "edit")
    scalar_eval_rescue(snps, frags, somatic_snps, cfg.min_phase_score - 3.0,
                       cfg.min_linkers, apply_ds, rng7, "somatic")
    read_assignments = scalar_assign_reads(snps, frags, cutoff, False)
    scalar_assign_snp(snps, frags, cfg.min_linkers, False)
    phase_sets = scalar_assign_phase_set(snps, frags, cfg.min_phase_score)

    vcf_lines = scalar_output_vcf(snps, region.chr, cfg.min_phase_score)
    return vcf_lines, read_assignments, phase_sets


# ---------------------------------------------------------------------------
# External -v candidates (candidate.rs:530-613) and the full closure with
# input_candidates / exon_mask wiring
# ---------------------------------------------------------------------------

def scalar_import_candidates(pileup, ref_seq, chr_cands,
                             min_variant_qual=0.0):
    """Literal per-column transcription of the -v import: candidate
    sites/genotypes come from the input VCF instead of discovery; 0/0 and
    'other' records are dropped, 1/2 becomes a triallelic het entry."""
    region = pileup.region
    start0 = region.start - 1
    out = []
    for col in range(pileup.length):
        pos = start0 + col
        gq = chr_cands.get(pos)
        if gq is None or gq.genotype in (0, 4):
            continue
        if gq.quality < min_variant_qual:
            continue
        cnt4 = pileup.cnt[col]
        cov = int(cnt4.sum())
        ref_ch = chr(ref_seq[pos])
        x = sorted(zip("ACGT", cnt4.tolist()), key=lambda t: -t[1])
        a1, c1, a2, c2 = x[0][0], x[0][1], x[1][0], x[1][1]
        if a1 != ref_ch and a2 != ref_ch:        # ref-promotion on count tie
            if x[2][1] == c2 and x[2][0] == ref_ch:
                a2, c2 = x[2][0], x[2][1]
            elif x[3][1] == c2 and x[3][0] == ref_ch:
                a2, c2 = x[3][0], x[3][1]
        f1 = float(np.float32(c1) / np.float32(cov)) if cov else 0.0
        f2 = float(np.float32(c2) / np.float32(cov)) if cov else 0.0
        g = gq.genotype
        out.append(dict(pos=pos, alleles=(a1, a2), allele_freqs=(f1, f2),
                        reference=ref_ch, depth=cov,
                        variant_quality=gq.quality,
                        genotype_quality=gq.quality,
                        variant_type={1: 1, 2: 2, 3: 3}[g],
                        genotype={1: 0, 2: -1, 3: -1}[g],
                        rna_editing=False, cand_somatic=False, dense=False,
                        hom_var=g == 2, het_var=g in (1, 3),
                        for_phasing=True))
    return out
