"""Bucketed multi-region phasing (torch, one device or a regions mesh).

Port of ``longcallr_tpu/phasing/batch_driver.py``. Prepared regions are
grouped by padded (K, I) bucket and a whole bucket runs through the
programs of ``parallel/mesh.py``: every launch of the iterative phase()
path (first ascent → block flip → perturbation schedule) serves all the
bucket's regions at once instead of one region. Enumeration regions
(≤ max_enum_snps candidates) batch by (K bucket, exact candidate count),
regions × configs, each region's configs sharing that region's tables.

What carries over exactly: the bucketing keys and their sorted order, each
region's own random stream consumed in the order of the per-region path
(``optimize._phase_region_padded_impl``), the fused-first / staged-on-refusal
order with its NaN polarity, the enumeration keep-best, the safety net and
the stage counters (beside them a census: ``phase_buckets``,
``phase_enum_buckets`` and ``phase_single_regions`` count the iterative
buckets, the enumeration buckets and the regions phased alone), and the
placement by work: one router call per bucket
(``utils/device.phase_placement``), and a bucket of little work on a card
run goes member by member through the per-region path, in float64 on the
card for an enumeration bucket and on the host for an iterative one.

With ``mesh=`` (``parallel/mesh.make_mesh``) every bucket is cut along the
mesh's "regions" axis, once, and its rows run the bucket programs at the
same time, as in the JAX package: no router call and no CPU cap for a
bucket then, and BUCKET_MAX_BYTES bounds a row's share. The enumeration
keep-best stays on the host; single enumeration regions, giant regions,
the safety net's margins and its f64 recomputes stay on ``device``.

What does not carry over: the bucket's cells travel in their 2-byte form.
"""

from __future__ import annotations

import os as _os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import CallerConfig
from ..ops.candidates import CandidateSet
from ..parallel import giant
from ..parallel import mesh as M
from ..utils.device import Placement, phase_placement, resolve_device
from ..utils.spans import span, stage_add
from . import kernels_fast as KF
from . import optimize as O
from . import rng as R
from .fragments import FragmentMatrix
from .kernels import TIE_TOL, make_cell_tables_np
from .optimize import (PhaseState, _bucket, block_flip_pass, compute_ld_blocks,
                       enumeration_order, init_genotype, init_haplotypes_ld,
                       phase_region)

# On the CPU the batch couples convergence: every trip of the masked ascent
# touches all B members until the slowest has converged, so a large bucket
# wastes serial work. Buckets are cut to this many members there; the cut is
# output-invariant (per-region seed streams).
CPU_BUCKET_B_CAP = int(_os.environ.get("LONGCALLR_CPU_BUCKET_B_CAP", "6"))

# Device bytes one bucket may hold live (a tenth of an 80 GB card, so that
# the waves in flight and the per-region reruns fit beside it). The
# split-table build makes about ten f32 [B,K,I] temporaries beside the
# 2-byte cells and the 8-byte split Dp, the block flip three more and
# [B,I,I] one-hots, and the safety net the f64 tables. _CELL_BYTES a cell
# and _SITE2_BYTES per I² estimate it: a whole split-mode run of a
# [4, 4096, 512] bucket peaked at 77.1 bytes a cell on an NVIDIA H100 80GB
# (chip_smoke.py, phase batched (f): 646,584,320 bytes, of which 74.1 a
# cell beside the I² term). The f64 chain and a bucket whose members fail
# the safety net were not measured; the tenth leaves them room. A bucket
# over the limit is cut into sub-buckets (output-invariant, like
# CPU_BUCKET_B_CAP).
BUCKET_MAX_BYTES = 8 << 30
_CELL_BYTES = 80
_SITE2_BYTES = 24


def _max_members(K: int, I_pad: int) -> int:
    per_member = K * I_pad * _CELL_BYTES + I_pad * I_pad * _SITE2_BYTES
    return max(1, BUCKET_MAX_BYTES // per_member)


@dataclass
class _Prepared:
    index: int
    frags: FragmentMatrix
    cands: CandidateSet
    seed: int
    apply_ds: bool


def phase_regions_batched(items: List[Tuple[FragmentMatrix, CandidateSet, int, bool]],
                          cfg: CallerConfig,
                          device: Optional[torch.device] = None,
                          mesh: Optional[M.Mesh] = None
                          ) -> List[Optional[PhaseState]]:
    """Phase many regions on ``device`` (``None``: the CUDA device, and it
    raises where there is none), the buckets on the rows of ``mesh`` where
    one is given; returns per-item PhaseState (host numpy, true unpadded
    shapes) in input order. Items with no candidates or no fragments →
    None."""
    device = resolve_device() if device is None else torch.device(device)
    out: List[Optional[PhaseState]] = [None] * len(items)
    buckets: Dict[Tuple[int, int], List[_Prepared]] = {}
    enum_buckets: Dict[Tuple[int, int], List[_Prepared]] = {}
    for idx, (frags, cands, seed, apply_ds) in enumerate(items):
        K0, I0 = frags.p.shape
        if I0 == 0 or K0 == 0:
            continue
        if I0 <= cfg.max_enum_snps:
            # enumeration regions batch by (K bucket, exact candidate count):
            # the same logical I shares the 2^I config matrix
            enum_buckets.setdefault((_bucket(K0), I0), []).append(
                _Prepared(idx, frags, cands, seed, apply_ds))
            continue
        if _bucket(K0) * _bucket(I0) >= giant.GIANT_CELLS:
            # a giant region stays out of the padded buckets (one such
            # member would set the whole batch's footprint): phase_region
            # routes it, to the reads-sharded ascent where there are cards
            stage_add("phase_single_regions", 1)
            with span("phase.single_region"):
                out[idx] = phase_region(frags, cands, cfg, seed, apply_ds,
                                        device=device)
            continue
        buckets.setdefault((_bucket(K0), _bucket(I0)), []).append(
            _Prepared(idx, frags, cands, seed, apply_ds))

    for (K, I0), group in sorted(enum_buckets.items()):
        if len(group) == 1:
            it = group[0]
            stage_add("phase_single_regions", 1)
            with span("phase.single_region"):
                out[it.index] = phase_region(it.frags, it.cands, cfg, it.seed,
                                             it.apply_ds, device=device)
        else:
            with span("phase.enum_bucket"):
                _phase_enum_bucket(group, cfg, K, I0, device, out, mesh)
    for (K, I_pad), group in sorted(buckets.items()):
        with span("phase.bucket"):
            _phase_bucket(group, cfg, K, I_pad, device, out, mesh)
    return out


def _region_rng(cfg: CallerConfig, seed: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, seed & 0x7FFFFFFF]))


def _fill_cells(group: List[_Prepared], K: int, I_pad: int):
    """The bucket's padded cells and masks (host numpy)."""
    B = len(group)
    p = np.zeros((B, K, I_pad), np.int8)
    bq = np.zeros((B, K, I_pad), np.uint8)
    read_base = np.zeros((B, K), bool)
    site_mask = np.zeros((B, I_pad), bool)
    for b, it in enumerate(group):
        K0, I0 = it.frags.p.shape
        p[b, :K0, :I0] = it.frags.p
        bq[b, :K0, :I0] = it.frags.baseq
        ds = it.frags.downsampled if it.apply_ds else np.ones(K0, bool)
        read_base[b, :K0] = it.frags.for_phasing & ds
        site_mask[b, :I0] = it.cands.for_phasing
    return p, bq, read_base, site_mask


def _cap(K: int, I_pad: int, mesh) -> int:
    """Members a bucket may hold: BUCKET_MAX_BYTES bounds one device's
    share, so a mesh holds that many in each row."""
    return _max_members(K, I_pad) * (1 if mesh is None else mesh.shape[0])


def _bucket_on(group_arrays, device: torch.device, mesh):
    """A bucket's arrays (host numpy) as the programs take them: a
    BatchedRegions on ``device``, or cut over the rows of ``mesh``
    (M.shard_regions). Returns (batch, the device of the state
    arguments: ``device``, or the host for a mesh, whose rows take their
    share of each state and hand back their results there)."""
    if mesh is None:
        return M.BatchedRegions.from_numpy(*group_arrays, device), device
    return (M.shard_regions(M.BatchedRegions(*group_arrays), mesh),
            torch.device("cpu"))


def _f64_margins(device: torch.device, p, bq, read_base, site_mask, sgf,
                 dlf, etf) -> np.ndarray:
    """The safety net's f64 decision margins of a bucket's final states, in
    one pass on ``device``."""
    on = lambda a: torch.as_tensor(a, device=device)
    return O.f64_decision_margin_batched(
        on(p), on(bq), on(sgf), on(dlf), on(etf), on(read_base),
        on(site_mask)).cpu().numpy()


def _safety_net(split: bool) -> bool:
    """Whether a split-mode result is re-checked in f64 (and a near-tie
    member recomputed). Forced split mode has no exact rerun."""
    return bool(O.USE_FAST_KERNELS and split and O.F32_SAFETY_TOL > 0
                and not O.USE_F32_KERNELS)


def _placed_per_region(group: List[_Prepared], cfg: CallerConfig,
                        work: int, enumeration: bool, device: torch.device,
                        out: List[Optional[PhaseState]]) -> bool:
    """The bucket's one router call. A bucket of little work on a card run
    is phased here, member by member on the per-region path (byte-equal by
    the batched == per-region seed contract, and without a bucket program's
    launches): an enumeration bucket in float64 on the card, an iterative
    one on the host. Returns whether it was."""
    placed = phase_placement(work, device, enumeration)
    if placed == Placement(device):
        return False
    with span("phase.card_f64_placed" if placed.f64
              else "phase.host_placed"):
        for it in group:
            out[it.index] = O.phase_region_on(it.frags, it.cands, cfg,
                                              it.seed, it.apply_ds,
                                              placed.device,
                                              O.placed_split(placed))
    return True


def _phase_enum_bucket(group: List[_Prepared], cfg: CallerConfig, K: int,
                       I0: int, device: torch.device,
                       out: List[Optional[PhaseState]], mesh=None) -> None:
    """Batched 2^I enumeration (phase.rs:1097-1122) for regions sharing the
    same config matrix; chunked over configs to bound memory."""
    I_pad = _bucket(max(1, I0))
    bmax = _cap(K, I_pad, mesh)
    if len(group) > bmax:
        for i in range(0, len(group), bmax):
            _phase_enum_bucket(group[i:i + bmax], cfg, K, I0, device, out,
                               mesh)
        return
    B = len(group)
    C_est = enumeration_order(I0).shape[0]
    if mesh is None and _placed_per_region(group, cfg, B * C_est * K * I_pad,
                                           True, device, out):
        return
    stage_add("phase_enum_buckets", 1)
    p, bq, read_base, site_mask = _fill_cells(group, K, I_pad)
    eta0 = np.ones((B, I_pad), np.float64)
    for b, it in enumerate(group):
        eta0[b, :I0] = init_genotype(it.cands)
    configs = enumeration_order(I0).astype(np.float64)
    configs = np.pad(configs, ((0, 0), (0, I_pad - I0)), constant_values=1.0)
    C = configs.shape[0]
    sig0 = np.zeros((B, C, K), np.float64)
    for b, it in enumerate(group):
        s = np.where(_region_rng(cfg, it.seed).random((C, K)) < 0.5, -1.0, 1.0)
        sig0[b] = np.where(read_base[b][None, :], s, 0.0)

    batch, home = _bucket_on((p, bq, read_base, site_mask,
                              np.zeros((B, I_pad), bool)), device, mesh)
    dp = lambda a: torch.as_tensor(a, device=home)
    split = O.split_mode(device if mesh is None else M.mesh_device(mesh))
    # every config's σ is non-zero exactly on read_base: a chunk's ascent
    # program builds one table per region for all its configs
    eta0_d = dp(eta0)

    chunk = max(1, int(2 ** 24 // max(1, B * K * I_pad)))
    chunk = min(C, 1 << (chunk.bit_length() - 1))
    best_prob = np.full(B, -np.inf)
    best: List[Optional[tuple]] = [None] * B
    best_idx = np.full(B, -1)
    all_pr: List[np.ndarray] = []
    for c0 in range(0, C, chunk):
        sg, dl, et, pr = M.batched_enum_cross_optimize(
            batch, dp(sig0[:, c0:c0 + chunk]), dp(configs[c0:c0 + chunk]),
            eta0_d, split=split, mesh=mesh)
        pr = pr.cpu().numpy()                    # [B, chunk]
        all_pr.append(pr)
        with span("phase.keep_best"):
            for b in range(B):
                # sequential tie-quantized keep-best: the first config in
                # enumeration order wins structural ties, independent of
                # summation order — the rule of optimize's enumeration leg
                sel = -1
                for j in range(pr.shape[1]):
                    if pr[b, j] > best_prob[b] + TIE_TOL:
                        best_prob[b] = float(pr[b, j])
                        sel = j
                if sel >= 0:
                    best[b] = (sg[b, sel], dl[b, sel], et[b, sel])
                    best_idx[b] = c0 + sel
    sgf, dlf, etf = (torch.stack([best[b][k] for b in range(B)]).cpu().numpy()
                     for k in range(3))
    for b, it in enumerate(group):
        K0, _ = it.frags.p.shape
        out[it.index] = PhaseState(sgf[b, :K0], dlf[b, :I0], etf[b, :I0])

    # safety net, enumeration leg (the contract of the per-region
    # enumeration path): recompute a region in f64 when the winning state's
    # f64 decision margins are inside the split error bound, or when any
    # other config's prob sits within the bound of the winner's — above it
    # included (the sequential TIE_TOL keep-best can leave a later config up
    # to TIE_TOL above the winner; its gap reads negative and forces the
    # rerun).
    if not _safety_net(split):
        if split:
            for _ in group:
                O._note(kept=True)
        return
    pr_all = np.concatenate(all_pr, axis=1)          # [B, C]
    margins = _f64_margins(device, p, bq, read_base, site_mask, sgf, dlf, etf)
    for b, it in enumerate(group):
        others = np.delete(pr_all[b], int(best_idx[b]))
        cfg_gap = (best_prob[b] - float(others.max())
                   if others.size else np.inf)
        if min(float(margins[b]), cfg_gap) < O.F32_SAFETY_TOL:
            out[it.index] = O.phase_region_f64(it.frags, it.cands, cfg,
                                               it.seed, it.apply_ds, device)
        else:
            O._note(kept=True)


def _phase_bucket(group: List[_Prepared], cfg: CallerConfig, K: int,
                  I_pad: int, device: torch.device,
                  out: List[Optional[PhaseState]], mesh=None) -> None:
    cap = _cap(K, I_pad, mesh)
    if mesh is None and device.type == "cpu":
        cap = min(cap, max(1, CPU_BUCKET_B_CAP))
    if len(group) > cap:
        # output-invariant: per-region seed streams, per-member tables
        for i in range(0, len(group), cap):
            _phase_bucket(group[i:i + cap], cfg, K, I_pad, device, out, mesh)
        return

    B = len(group)
    max_rounds = max(it.frags.p.shape[1] // 4 + 1 for it in group)
    if mesh is None and _placed_per_region(group, cfg,
                                           B * K * I_pad * max_rounds, False,
                                           device, out):
        return
    stage_add("phase_buckets", 1)
    conserved = np.zeros((B, I_pad), bool)
    sigma0 = np.zeros((B, K), np.float64)
    delta0 = np.ones((B, I_pad), np.float64)
    eta0 = np.ones((B, I_pad), np.float64)
    n_rounds = np.zeros(B, np.int64)
    lds = []
    region_keys = []
    with span("phase.tables", key="phase_tables"):
        p, bq, read_base, site_mask = _fill_cells(group, K, I_pad)

    # per-region LD blocks and state init. Each region consumes its OWN rng
    # stream in exactly the order of the per-region path
    # (optimize._phase_region_padded_impl): init_haplotypes_ld → padded-K
    # sigma draw → int64 key draw. This makes batched == per-region and
    # keeps a region's result independent of its bucket-mates.
    for b, it in enumerate(group):
        K0, I0 = it.frags.p.shape
        n_rounds[b] = I0 // 4 + 1
        rng = _region_rng(cfg, it.seed)
        ld = compute_ld_blocks(it.cands, it.frags)
        lds.append(ld)
        d0, cons = init_haplotypes_ld(it.cands, ld, rng)
        delta0[b, :I0] = d0
        conserved[b, :I0] = cons
        eta0[b, :I0] = init_genotype(it.cands)
        s0 = np.where(rng.random(K) < 0.5, -1.0, 1.0)
        sigma0[b] = np.where(read_base[b], s0, 0.0)
        region_keys.append(R.prng_key(
            int(rng.integers(0, np.iinfo(np.int64).max, dtype=np.int64))))

    with span("phase.tables", key="phase_tables"):
        batch, home = _bucket_on((p, bq, read_base, site_mask, conserved),
                                 device, mesh)
    dp = lambda a: torch.as_tensor(a, device=home)

    split = O.split_mode(device if mesh is None else M.mesh_device(mesh))
    device_flip = bool(O.USE_FAST_KERNELS and split)
    bid_np = np.full((B, I_pad), -1, np.int32)
    for b in range(B):
        blk = lds[b].block_id
        bid_np[b, :blk.shape[0]] = blk
    host = lambda *ts: tuple(a.cpu().numpy() for a in ts)

    sgf = None
    if device_flip:
        # 0) fused whole-phase program: ascent1 → block flip → keep-best →
        # perturbation schedule over one shared table build
        # (mesh.batched_phase_fused, bit-identical to the staged sequence
        # below). When any region's block-flip margin is inside the f32
        # envelope (NaN counted as inside), discard and rerun staged — its
        # host-exact flip defines the semantics. A discarded attempt was
        # still fused work: its wall stays in phase_fused, out of the staged
        # rerun's phase_ascent1.
        with span("phase.fused", key="phase_fused"):
            sgf_d, dlf_d, etf_d, _, margins = M.batched_phase_fused(
                batch, dp(sigma0), dp(delta0), dp(eta0), dp(bid_np), n_rounds,
                region_keys, split=True, mesh=mesh)
            if bool((margins >= KF.F32_BF_TOL).all()):
                sgf, dlf, etf = host(sgf_d, dlf_d, etf_d)
            else:
                stage_add("phase_fused_refused", 1)

    if sgf is None:
        # 1) first ascent (keep_conserved=True, phase.rs:1132)
        with span("phase.ascent1", key="phase_ascent1"):
            sg, dl, et, prob1 = M.batched_cross_optimize(
                batch, dp(sigma0), dp(delta0), dp(eta0),
                keep_conserved=True, with_genotype=False, split=split,
                mesh=mesh)
            sg_np, dl_np, et_np, prob1_np = host(sg, dl, et, prob1)

        # 2) block-flip pass per region against the ascent's state. In split
        # mode the whole bucket runs as one device pass over the split
        # tables (block decisions have no sequential dependence); a region
        # whose smallest per-block decision margin sits inside the f32
        # error envelope is recomputed with the exact host pass, so its
        # decisions match the f64 path. In f64 mode the host pass runs per
        # member (over a thread pool when the config has threads).
        with span("phase.blockflip", key="phase_blockflip"):
            sg2 = sg_np.copy()
            dl2 = dl_np.copy()

            def _flip_one(b: int) -> None:
                ct_b = make_cell_tables_np(p[b], bq[b])
                st2 = block_flip_pass(ct_b, PhaseState(sg_np[b], dl_np[b],
                                                       et_np[b]),
                                      read_base[b], site_mask[b],
                                      np.asarray(ct_b.exists), lds[b])
                sg2[b] = np.asarray(st2.sigma)
                dl2[b] = np.asarray(st2.delta)

            prob2_np = None
            if device_flip:
                sg2_d, dl2_d, prob2_d, margins = M.batched_block_flip(
                    batch, sg, dl, et, dp(bid_np), split=True, mesh=mesh)
                sg2, dl2, prob2_np, margins_np = host(sg2_d, dl2_d, prob2_d,
                                                      margins)
                sg2, dl2, prob2_np = sg2.copy(), dl2.copy(), prob2_np.copy()
                # ~(>=), not (<): a NaN margin (a baseq-0 cell puts NaN
                # into the split lo table) is UNSAFE and takes the exact
                # host pass — the polarity of the fused gate above
                bad = np.flatnonzero(~(margins_np >= KF.F32_BF_TOL))
                for b in bad:
                    stage_add("phase_blockflip_exact", 1)
                    _flip_one(int(b))
                if bad.size:
                    # rescore only the host-recomputed regions (their
                    # in-pass prob2 scored the device flip); members are
                    # numerically independent, so a kept value never depends
                    # on bucket-mates
                    pr_re = M.batched_overall_probability(
                        batch, dp(sg2), dp(dl2), et, split=True,
                        mesh=mesh).cpu().numpy()
                    prob2_np[bad] = pr_re[bad]
            elif cfg.threads > 1 and B > 1:
                with ThreadPoolExecutor(max_workers=min(cfg.threads, B)) as ex:
                    list(ex.map(_flip_one, range(B)))
            else:
                for b in range(B):
                    _flip_one(b)

            # score the flipped states (the reference scores the flip without
            # re-optimizing, phase.rs:1139-1144) and keep the per-region best
            if prob2_np is None:
                prob2_np = M.batched_overall_probability(
                    batch, dp(sg2), dp(dl2), et, split=split,
                    mesh=mesh).cpu().numpy()
            better = prob2_np > prob1_np + TIE_TOL
            best_sg = np.where(better[:, None], sg2, sg_np)
            best_dl = np.where(better[:, None], dl2, dl_np)
            best_prob = np.where(better, prob2_np, prob1_np)

        # 3) perturbation schedule with per-region round counts and keys
        with span("phase.perturb", key="phase_perturb"):
            sgf_d, dlf_d, etf_d, _ = M.batched_perturbation_phase(
                batch, dp(best_sg), dp(best_dl), et,
                dp(best_prob.astype(np.float64)), n_rounds, region_keys,
                split=split, mesh=mesh)
            sgf, dlf, etf = host(sgf_d, dlf_d, etf_d)
    for b, it in enumerate(group):
        K0, I0 = it.frags.p.shape
        out[it.index] = PhaseState(sgf[b, :K0], dlf[b, :I0], etf[b, :I0])

    # safety net (the contract of the per-region path): the whole bucket's
    # margins re-checked in exact f64 in one pass on the device; a near-tie
    # member is recomputed alone in f64.
    if not _safety_net(split):
        if split:
            for _ in group:
                O._note(kept=True)
        return
    with span("phase.safety", key="phase_safety"):
        margins = _f64_margins(device, p, bq, read_base, site_mask, sgf, dlf,
                               etf)
        for b, it in enumerate(group):
            # not (>=): a NaN margin means the f64 re-evaluation itself
            # degenerated — recompute, the polarity of the flip gates
            if not margins[b] >= O.F32_SAFETY_TOL:
                out[it.index] = O.phase_region_f64(it.frags, it.cands, cfg,
                                                   it.seed, it.apply_ds,
                                                   device)
            else:
                O._note(kept=True)
