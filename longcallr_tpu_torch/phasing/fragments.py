"""Fragment extraction: reads × candidate-SNPs allele matrices.

Redesign of ``longcallR/src/fragment.rs:10-309``
(SNPFrag::get_fragments). The reference builds per-read Vec<FragElem> lists
plus HashMap LD-pair counts; here each region produces a dense
``[K reads × I candidates]`` cell matrix (int8 p-allele, uint8 capped baseq)
that feeds the batched phasing kernels directly, plus vectorised LD pair
counts.

Replicated semantics:
  * p = +1 if base == reference, -1 if base in {allele1, allele2} and != ref,
    else 0 (fragment.rs:134-143); only p != 0 cells at non-dense candidates
    enter the fragment (fragment.rs:148-152);
  * baseq capped at 30; prob = 10^(-q/10) (fragment.rs:127-133);
  * num_hete_links counts phase-site cells; for_phasing = links >=
    min_linkers (fragment.rs:242-254);
  * LD pair counts: for LD-consumed pairs (both SNPs biallelic-with-ref,
    candidate.rs:640-665) the base→{ref,alt} mapping is a bijection of p, so
    counts are accumulated directly as 2×2 (ref/alt)² tables — exactly the
    entries ``calculate_ld`` (snp.rs:158-188) reads.

The reference also accumulates ``SNPFrag.edges`` (fragment.rs:266-292), but
no live code path consumes them — not materialised here.

Copied from ``longcallr_tpu/phasing/fragments.py`` (host numpy code, the
same logic); the imports differ — every module comes from the torch package —
and comments that cited the JAX package's host timings are shortened.
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import CallerConfig, MAX_BASE_QUALITY
from ..io.bam import BamFile
from ..tiles.regions import Region

from ..ops.candidates import CandidateSet

_M, _I, _D, _N, _S, _H, _P, _EQ, _X = range(9)


@dataclass
class FragmentMatrix:
    """Dense fragment/candidate incidence data for one region."""

    region: Region
    # cells: exists iff the read has a p!=0 base at a non-dense candidate
    p: np.ndarray            # [K,I] int8 in {-1,0,+1}; 0 == no cell
    baseq: np.ndarray        # [K,I] uint8 (capped at 30), valid where p != 0
    qnames: List[str]
    num_hete_links: np.ndarray   # [K] int32
    for_phasing: np.ndarray      # [K] bool
    downsampled: np.ndarray      # [K] bool (all True unless downsampling)
    # haplotag sigma: 0 unassigned, ±1 (fragment.haplotag equivalent)
    haplotag: np.ndarray         # [K] int8
    assignment: np.ndarray       # [K] int8 (0/1/2)
    assignment_score: np.ndarray  # [K] float64
    # LD pair counts: key (i, j) with i < j (candidate indices), value 2x2
    # int32 [a_i in {ref=0, alt=1}][a_j] — only pairs where both SNPs have
    # ref among alleles (the only pairs calculate_ld consumes)
    ld_counts: Dict[Tuple[int, int], np.ndarray] = field(default_factory=dict)
    # flat CSR view of the nonzero cells (read-major, ascending candidate
    # index within a read): the assignment layer's native histogram kernels
    # walk these instead of the dense [K,I] matrices. Built by get_fragments;
    # flat_cells() derives them from p/baseq for hand-constructed matrices.
    cells_off: Optional[np.ndarray] = None   # [K+1] int64 prefix offsets
    cells_i: Optional[np.ndarray] = None     # [nnz] int32 candidate index
    cells_p: Optional[np.ndarray] = None     # [nnz] int8 in {-1,+1}
    cells_q: Optional[np.ndarray] = None     # [nnz] uint8 capped baseq
    # third-pass somatic baseq gather (populated when cfg.somatic is on;
    # None otherwise — ops/somatic.py then falls back to fragment cells)
    somatic_gather: Optional["SomaticGather"] = None

    def flat_cells(self):
        """(cells_off, cells_i, cells_p, cells_q), derived from the dense
        matrices on first use when get_fragments didn't populate them."""
        if self.cells_off is None:
            kk, ii = np.nonzero(self.p)
            K = self.p.shape[0]
            off = np.zeros(K + 1, np.int64)
            np.cumsum(np.bincount(kk, minlength=K), out=off[1:])
            self.cells_off = off
            self.cells_i = ii.astype(np.int32)
            self.cells_p = self.p[kk, ii]
            self.cells_q = self.baseq[kk, ii]
        return self.cells_off, self.cells_i, self.cells_p, self.cells_q

    @property
    def n_frags(self) -> int:
        return self.p.shape[0]

    @property
    def n_snps(self) -> int:
        return self.p.shape[1]

    def exists(self) -> np.ndarray:
        return self.p != 0


def _read_cells(read, cand_pos: np.ndarray, start_idx: int, end_idx: int,
                ref_alleles: np.ndarray, alleles: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (cand_indices, p, baseq) for candidate SNPs under M-ops of this
    read. cand_pos[start_idx:end_idx] are the candidates in the read span."""
    if start_idx >= end_idx:
        return (np.empty(0, np.int64),) * 3
    sub_pos = cand_pos[start_idx:end_idx]
    ops = read.cigar_ops
    lens = read.cigar_lens
    # M-segment tables
    seg_r: List[int] = []
    seg_q: List[int] = []
    seg_l: List[int] = []
    rpos = read.pos
    qpos = read.leading_softclips()
    for op, ln in zip(ops.tolist(), lens.tolist()):
        if op in (_S, _H, _P):
            continue
        if op in (_M, _EQ, _X):
            seg_r.append(rpos)
            seg_q.append(qpos)
            seg_l.append(ln)
            rpos += ln
            qpos += ln
        elif op == _I:
            qpos += ln
        elif op in (_D, _N):
            rpos += ln
    if not seg_r:
        return (np.empty(0, np.int64),) * 3
    seg_r_arr = np.asarray(seg_r, dtype=np.int64)
    seg_l_arr = np.asarray(seg_l, dtype=np.int64)
    seg_q_arr = np.asarray(seg_q, dtype=np.int64)
    # locate each candidate position in the M segments
    si = np.searchsorted(seg_r_arr, sub_pos, side="right") - 1
    si_c = np.clip(si, 0, len(seg_r) - 1)
    inside = (si >= 0) & (sub_pos < seg_r_arr[si_c] + seg_l_arr[si_c])
    if not inside.any():
        return (np.empty(0, np.int64),) * 3
    hit = np.nonzero(inside)[0]
    qidx = seg_q_arr[si_c[hit]] + (sub_pos[hit] - seg_r_arr[si_c[hit]])
    seq = read.seq
    qual = read.qual
    base = seq[qidx]
    bq = np.minimum(qual[qidx], MAX_BASE_QUALITY)
    ci = hit + start_idx
    ref_b = ref_alleles[ci]
    a0 = alleles[ci, 0]
    a1 = alleles[ci, 1]
    p = np.where(base == ref_b, 1,
                 np.where((base == a0) | (base == a1), -1, 0)).astype(np.int8)
    return ci, p, bq


# read count above which the native extraction runs chunk-parallel
# (fixed 16-chunk layout, outputs identical to the serial walk)
FRAG_MT_MIN = int(_os.environ.get("LONGCALLR_FRAG_MT_MIN", "1024"))


def _extract_cells_flat(bam: BamFile, eligible: List[int], cands: CandidateSet,
                        use_native: bool = True, threads: int = 1
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All cells of all eligible reads as flat arrays
    ``(counts[K], cand_idx, p, baseq)`` — cells of read k occupy the segment
    ``[cumsum(counts)[k-1], cumsum(counts)[k])``. Native C++ when available,
    numpy fallback otherwise."""
    cand_pos = cands.pos
    K = len(eligible)
    if use_native and eligible:
        from .. import native
        nlib = native.lib()
        if nlib is not None:
            import ctypes
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i8p = ctypes.POINTER(ctypes.c_int8)
            data = np.frombuffer(bam._data, dtype=np.uint8)
            idx = np.asarray(eligible, dtype=np.int64)
            rec_off = bam.rec_off[idx].astype(np.int64)
            rec_end = bam.rec_end[idx].astype(np.int64)
            n_cand = cands.n
            # worst case: every read covers every candidate
            max_cells = int(K) * max(1, n_cand)
            max_cells = min(max_cells, 1 << 28)
            out_idx = np.empty(max_cells, np.int32)
            out_p = np.empty(max_cells, np.int8)
            out_bq = np.empty(max_cells, np.uint8)
            out_counts = np.empty(K, np.int64)
            a1 = np.ascontiguousarray(cands.alleles[:, 0])
            a2 = np.ascontiguousarray(cands.alleles[:, 1])
            nd = np.ones(n_cand, np.uint8)  # dense filter applied by caller
            ptr = lambda a, t: a.ctypes.data_as(t)
            args = (
                ptr(data, u8p), ptr(rec_off, i64p), ptr(rec_end, i64p),
                K, ptr(cand_pos, i64p), ptr(cands.ref_base, u8p),
                ptr(a1, u8p), ptr(a2, u8p), ptr(nd, u8p), n_cand,
                ptr(out_idx, i32p), ptr(out_p, i8p), ptr(out_bq, u8p),
                ptr(out_counts, i64p), max_cells)
            if (threads > 1 and K >= FRAG_MT_MIN
                    and max_cells == K * max(1, n_cand)
                    and hasattr(nlib, "fragment_cells_mt")):
                rc = nlib.fragment_cells_mt(*args, threads)
            else:
                rc = nlib.fragment_cells(*args)
            if rc == 0:
                total = int(out_counts.sum())
                return (out_counts, out_idx[:total].astype(np.int64),
                        out_p[:total].copy(), out_bq[:total].copy())
    counts = np.zeros(K, np.int64)
    ps: List[np.ndarray] = []
    qs: List[np.ndarray] = []
    cs: List[np.ndarray] = []
    for j, ridx in enumerate(eligible):
        r = bam.read(ridx)
        s_idx = int(np.searchsorted(cand_pos, r.pos, side="left"))
        e_idx = int(np.searchsorted(cand_pos, r.reference_end(), side="left"))
        ci, p, bq = _read_cells(r, cand_pos, s_idx, e_idx,
                                cands.ref_base, cands.alleles)
        counts[j] = len(ci)
        cs.append(ci)
        ps.append(p)
        qs.append(bq)
    if K == 0:
        return (counts, np.empty(0, np.int64), np.empty(0, np.int8),
                np.empty(0, np.uint8))
    return (counts, np.concatenate(cs), np.concatenate(ps),
            np.concatenate(qs))


@lru_cache(maxsize=256)
def _triu_cached(m: int):
    """Upper-triangle pair indices, cached per size (the per-read pair loop
    re-requests the same handful of sizes thousands of times)."""
    return np.triu_indices(m, k=1)


# above this many candidates the dense [I,I] LD tables would dominate memory;
# fall back to the per-read pair-key loop (sized by cells², like the
# reference's per-pair HashMap)
LD_DENSE_MAX_I = 2048


def _ld_counts_native(nlib, P: np.ndarray, ld_cols: np.ndarray,
                      threads: int) -> Optional[Dict[Tuple[int, int], np.ndarray]]:
    """LD pair tables via the bit-packed popcount kernel
    (native/decode.cpp::ld_pair_counts) — integer-exact, so dicts are
    identical to the dense-GEMM path's (asserted in tests/test_native.py).
    The GEMM form streams [K,I] f32 indicator matrices through BLAS four
    times; the popcount form touches each column's packed bits once per
    overlapping pair. Returns None when the kernel is unavailable
    or the pair capacity would overflow (caller falls back)."""
    import ctypes
    K, I = P.shape
    cap = I * (I - 1) // 2
    # np.empty: pages are untouched until the kernel writes actual pairs
    out_i = np.empty(cap, np.int32)
    out_j = np.empty(cap, np.int32)
    out_c = np.empty(cap * 4, np.int32)
    Pc = np.ascontiguousarray(P)
    lc = np.ascontiguousarray(ld_cols.astype(np.uint8))
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    n = nlib.ld_pair_counts(ptr(Pc, ctypes.c_int8), K, I,
                            ptr(lc, ctypes.c_uint8),
                            ptr(out_i, ctypes.c_int32),
                            ptr(out_j, ctypes.c_int32),
                            ptr(out_c, ctypes.c_int32), cap, threads)
    if n < 0:
        return None
    tbls = out_c[:4 * n].reshape(n, 2, 2).copy()
    return {(int(i), int(j)): tbls[k]
            for k, (i, j) in enumerate(zip(out_i[:n].tolist(),
                                           out_j[:n].tolist()))}


def _ld_counts_dense(P: np.ndarray, ld_cols: np.ndarray
                     ) -> Dict[Tuple[int, int], np.ndarray]:
    """LD pair tables as four Gram matmuls: with R/A the [K,I] indicators of
    ref (+1) / alt (−1) cells at LD-consumable columns,
    ``table[(i,j)][a,b] = (Xa^T Xb)[i,j]`` — the per-read pair loop of
    ``fragment.rs:208-240`` collapsed into dense contractions. Chunked over
    reads to bound the f32 staging buffers."""
    K, I = P.shape
    rr = np.zeros((I, I), np.float64)
    ra = np.zeros((I, I), np.float64)
    ar = np.zeros((I, I), np.float64)
    aa = np.zeros((I, I), np.float64)
    step = max(1, (1 << 24) // max(1, I))     # ≤ ~128MB of f32 staging
    for k0 in range(0, K, step):
        blk = P[k0:k0 + step]
        R = ((blk == 1) & ld_cols[None, :]).astype(np.float32)
        A = ((blk == -1) & ld_cols[None, :]).astype(np.float32)
        rr += (R.T @ R).astype(np.float64)
        ra += (R.T @ A).astype(np.float64)
        ar += (A.T @ R).astype(np.float64)
        aa += (A.T @ A).astype(np.float64)
    tot = rr + ra + ar + aa
    iu, ju = np.nonzero(np.triu(tot, k=1))
    out: Dict[Tuple[int, int], np.ndarray] = {}
    for i, j in zip(iu.tolist(), ju.tolist()):
        out[(i, j)] = np.array([[rr[i, j], ra[i, j]],
                                [ar[i, j], aa[i, j]]], np.int32)
    return out


def get_fragments(bam: BamFile, region: Region, cands: CandidateSet,
                  cfg: CallerConfig, use_native: bool = True) -> FragmentMatrix:
    """Second BAM pass: build the fragment matrix for one region."""
    I = cands.n
    lo, hi = bam.contig_record_range(region.chr)
    ld_counts: Dict[Tuple[int, int], np.ndarray] = {}
    if I == 0 or lo == hi:
        return FragmentMatrix(
            region=region, p=np.zeros((0, I), np.int8),
            baseq=np.zeros((0, I), np.uint8), qnames=[],
            num_hete_links=np.zeros(0, np.int32),
            for_phasing=np.zeros(0, bool), downsampled=np.ones(0, bool),
            haplotag=np.zeros(0, np.int8), assignment=np.zeros(0, np.int8),
            assignment_score=np.zeros(0, np.float64), ld_counts=ld_counts)

    cand_pos = cands.pos
    last_pos = int(cand_pos[-1])
    not_dense = ~cands.dense
    phase_site = cands.for_phasing.copy()
    # LD-relevant snps: ref is among the two alleles (candidate.rs:640-665)
    ref_in_alleles = ((cands.alleles[:, 0] == cands.ref_base)
                      | (cands.alleles[:, 1] == cands.ref_base))

    # same fetch semantics as the pileup pass (fragment.rs:20-22)
    lo, hi, omask = bam.overlap_range(region.chr, region.start, region.end)
    qm = bam.qc_pass(cfg.min_mapq, cfg.min_read_length, cfg.divergence)[lo:hi]
    keepm = omask & qm & (bam.pos[lo:hi] <= last_pos)  # fragment.rs:52-54
    eligible = (lo + np.nonzero(keepm)[0]).tolist()
    qnames = bam.qnames_at(eligible)
    K = len(qnames)

    counts, ci, p, bq = _extract_cells_flat(bam, eligible, cands,
                                            use_native=use_native,
                                            threads=max(1, cfg.threads))
    # keep p != 0 cells at non-dense candidates (fragment.rs:148-152)
    keep = (p != 0) & not_dense[ci]
    kk = np.repeat(np.arange(K, dtype=np.int64), counts)[keep]
    ci, p, bq = ci[keep], p[keep], bq[keep]

    P = np.zeros((K, I), np.int8)
    Q = np.zeros((K, I), np.uint8)
    if len(ci):
        P[kk, ci] = p
        Q[kk, ci] = bq

    # LD pair counts over kept cell pairs within each read
    # (fragment.rs:208-240), restricted to pairs calculate_ld can consume
    ld_cols = ref_in_alleles & not_dense
    if len(ci) and ld_cols.any():
        if I <= LD_DENSE_MAX_I:
            ld_counts = None
            if use_native:
                from .. import native
                nlib = native.lib()
                if nlib is not None and hasattr(nlib, "ld_pair_counts"):
                    ld_counts = _ld_counts_native(nlib, P, ld_cols,
                                                  max(1, cfg.threads))
            if ld_counts is None:
                ld_counts = _ld_counts_dense(P, ld_cols)
        else:
            # giant-I fallback: packed per-read pair keys
            pair_keys: List[np.ndarray] = []
            I4 = 4 * I  # packed key: i1*(4I) + i2*4 + a1*2 + a2
            bounds = np.zeros(K + 1, np.int64)
            np.cumsum(np.bincount(kk, minlength=K), out=bounds[1:])
            ld_ok = ld_cols[ci]
            for k in range(K):
                seg = slice(bounds[k], bounds[k + 1])
                li = ci[seg][ld_ok[seg]]
                lp = (1 - p[seg][ld_ok[seg]].astype(np.int64)) // 2
                m = len(li)
                if m >= 2:
                    ia, ib = _triu_cached(m)
                    # candidate indices ascend within a read already
                    pair_keys.append(li[ia] * I4 + li[ib] * 4
                                     + lp[ia] * 2 + lp[ib])
            if pair_keys:
                allk = np.concatenate(pair_keys)
                uniq, cnts = np.unique(allk, return_counts=True)
                for key, c in zip(uniq.tolist(), cnts.tolist()):
                    i1, rest = divmod(key, I4)
                    i2, a = divmod(rest, 4)
                    tbl = ld_counts.get((i1, i2))
                    if tbl is None:
                        tbl = np.zeros((2, 2), np.int32)
                        ld_counts[(i1, i2)] = tbl
                    tbl[a // 2, a % 2] += c
    hete_links = ((P != 0) & phase_site[None, :]).sum(axis=1).astype(np.int32)
    assert cfg.min_linkers > 0, "min_linkers <= 0"
    for_phasing = hete_links >= cfg.min_linkers
    off = np.zeros(K + 1, np.int64)
    if K:
        np.cumsum(np.bincount(kk, minlength=K), out=off[1:])
    return FragmentMatrix(
        region=region, p=P, baseq=Q, qnames=qnames,
        num_hete_links=hete_links, for_phasing=for_phasing,
        downsampled=np.ones(K, bool),
        haplotag=np.zeros(K, np.int8), assignment=np.zeros(K, np.int8),
        assignment_score=np.zeros(K, np.float64), ld_counts=ld_counts,
        cells_off=off, cells_i=ci.astype(np.int32), cells_p=p, cells_q=bq)


@dataclass
class SomaticGather:
    """Per-read baseq observations at candidate-somatic sites, gathered with
    the exact read-set and matching rules of the reference's dedicated third
    BAM pass (``snpfrags.rs:56-189`` get_somatic_haplotype_baseqs):

      * reads: every fetched record that is mapped and not secondary /
        supplementary with ``pos <= last somatic site`` — NO mapq / length /
        divergence QC re-check (the reference relies on qname membership in
        ``phased_fragments`` only, applied later once assignments exist);
      * sites: the candidate-time ``somatic_snps`` snapshot — dense sites
        INCLUDED (the dense retain at candidate.rs:525-527 touches only
        homo/het lists, and unlike fragment cells, fragment.rs:148-152,
        the third pass has no dense exclusion);
      * cell rule: recorded iff ref ∈ {allele1, allele2} and base ∈
        {allele1, allele2}; ref-bucket iff base == ref; baseq capped at 30
        (snpfrags.rs:118-135).

    Cells are stored record-major in fetch order so per-site bucket order
    (and thus the sequential f64 products of somatic.rs) reproduces the
    reference's Vec push order bit-exactly."""

    som_idx: np.ndarray      # candidate-time somatic candidate indices
    rec_qnames: List[str]    # per gathered record, fetch order
    cell_rec: np.ndarray     # [nnz] record ordinal (ascending)
    cell_site: np.ndarray    # [nnz] index into som_idx
    cell_is_ref: np.ndarray  # [nnz] bool
    cell_baseq: np.ndarray   # [nnz] uint8 (capped at 30)


def gather_somatic_hap_quals(bam: BamFile, region: Region,
                             cands: CandidateSet) -> Optional[SomaticGather]:
    """The reference's third BAM pass (snpfrags.rs:56-189), minus the
    assignment routing — run at fragment time so the candidate-time
    ``somatic_snps`` snapshot is taken before rescue clears flags
    (the reference's ``self.somatic_snps`` is never mutated after
    candidate.rs:414). Routing by read assignment happens later in
    ``ops.somatic.detect_somatic_by_het``."""
    from ..io.bam import FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED

    som_idx = np.nonzero(cands.cand_somatic)[0]
    if som_idx.size == 0:
        return None
    sub_pos = cands.pos[som_idx]
    sub_ref = cands.ref_base[som_idx]
    sub_alleles = cands.alleles[som_idx]
    # site-level gate: ref must be among the two alleles (snpfrags.rs:122)
    ref_in = (sub_alleles[:, 0] == sub_ref) | (sub_alleles[:, 1] == sub_ref)

    lo, hi, omask = bam.overlap_range(region.chr, region.start, region.end)
    flags = bam.flag[lo:hi]
    bad = FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_SUPPLEMENTARY
    keep = omask & ((flags & bad) == 0) & (bam.pos[lo:hi] <= int(sub_pos[-1]))
    recs = (lo + np.nonzero(keep)[0]).tolist()

    rec_qnames: List[str] = []
    c_rec: List[np.ndarray] = []
    c_site: List[np.ndarray] = []
    c_ref: List[np.ndarray] = []
    c_q: List[np.ndarray] = []
    for j, ridx in enumerate(recs):
        r = bam.read(ridx)
        rec_qnames.append(r.qname)
        s_idx = int(np.searchsorted(sub_pos, r.pos, side="left"))
        e_idx = int(np.searchsorted(sub_pos, r.reference_end(), side="left"))
        ci, p, bq = _read_cells(r, sub_pos, s_idx, e_idx, sub_ref, sub_alleles)
        m = (p != 0) & ref_in[ci]   # base ∈ alleles and ref ∈ alleles
        if not m.any():
            continue
        ci, p, bq = ci[m], p[m], bq[m]
        c_rec.append(np.full(len(ci), j, np.int64))
        c_site.append(ci)
        c_ref.append(p == 1)        # p=+1 ⇔ base == ref (fragment.rs:134-136)
        c_q.append(bq.astype(np.uint8))
    cat = lambda xs, dt: (np.concatenate(xs) if xs else np.empty(0, dt))
    return SomaticGather(
        som_idx=som_idx, rec_qnames=rec_qnames,
        cell_rec=cat(c_rec, np.int64), cell_site=cat(c_site, np.int64),
        cell_is_ref=cat(c_ref, bool), cell_baseq=cat(c_q, np.uint8))


def downsample_fragments(frags: FragmentMatrix, downsample_depth: int,
                         seed: int) -> None:
    """Seeded downsampling (thread.rs:144-151, phase.rs:693-701). Uses numpy's
    seeded shuffle — same fixed-seed convention, different stream than Rust
    StdRng (see SURVEY.md §4 determinism caveat)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(frags.n_frags)[:downsample_depth]
    frags.downsampled[:] = False
    frags.downsampled[idx] = True
