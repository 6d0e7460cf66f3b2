"""Giant-region phasing with the reads axis sharded over several devices.

Port of ``longcallr_tpu/parallel/giant.py``. The reference runs each
region's ``phase()`` single-threaded inside one rayon worker (thread.rs:133,
phase.rs:1087-1296); a pathologically deep locus (tens of thousands of
overlapping reads over hundreds of SNPs) therefore serialises on one core.
Here such regions are routed to the reads-sharded ascent
(``parallel/mesh.py``: ``shard_cells`` + ``sharded_ascent``, the form of
``sharded_cross_optimize``): the [K, I] fragment matrix is cut into one
contiguous row shard per device, the σ half-step stays on its shard, and
the (δ, η) column sums are added in shard order in f64.

Algorithm structure mirrors ``optimize._phase_region_padded_impl``'s
iterative path (ascent → host block flips → perturbation schedule,
phase.rs:1123-1294); only the ascents are sharded, and the perturbation
loop runs on the host with a seeded numpy stream (same schedule shape:
``I//4 + 1`` rounds of {10% SNP resets, ascend, keep-best, 10% read flips,
ascend, keep-best}) — a stream of its own, not the per-region path's.

The ascent is f64 and uses plain ``@`` products, as the JAX package's
shard_map program does: no split-matvec kernel lies on this path (the
split-f32 kernels' split is exact only for the tables they build
themselves). On the card each ascent is a group of device programs, one
per shard, whose shards meet at the exchange kernel
(``phasing/cuda_exchange.py``) and read no loop flag on the host; the
region's shard tables stay on their devices for all its ascents, and one
host sync an ascent serves the keep-best, as the JAX package's
``float(prob)`` does.

Routing is automatic from ``optimize.phase_region`` when a region's padded
cell count reaches LONGCALLR_GIANT_CELLS (default 2**26) and the run's
device is CUDA with at least two cards in this process; see
``reads_devices``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CallerConfig
from ..ops.candidates import CandidateSet
from ..phasing.fragments import FragmentMatrix
from ..phasing.kernels import CellTables, make_cell_tables_np

# padded-cell threshold above which the iterative path is reads-sharded
# (and, in the batched driver, the region stays out of the padded buckets)
GIANT_CELLS = int(os.environ.get("LONGCALLR_GIANT_CELLS", str(1 << 26)))


def reads_devices(device) -> Optional[List[torch.device]]:
    """The "reads" axis for a run on ``device``: the largest power-of-two
    prefix of THIS PROCESS's CUDA devices when ``device`` is CUDA; None
    with fewer than two, and on the CPU (one host).

    This process's devices, not a pod's: in a multi-process pod each
    process phases its own region shard independently."""
    if torch.device(device).type != "cuda":
        return None
    n = torch.cuda.device_count()
    n = 1 << (n.bit_length() - 1) if n else 0
    if n < 2:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def _np_matvec_objective(ct_np: CellTables, sigma, delta, eta,
                         read_mask, site_mask) -> float:
    """Host overall log10 probability in matvec form (phase.rs:257-276;
    algebra as kernels_fast.py: term = lerr + diff*(1 + p*x)/2)."""
    m = site_mask[None, :] & ct_np.exists
    diff = np.where(m, ct_np.l1m - ct_np.lerr, 0.0)
    lerr_m = np.where(m, ct_np.lerr, 0.0)
    dp = diff * ct_np.p
    u = np.where(eta == 0, delta, 0.0)
    v = np.where(eta == 0, 0.0, eta)
    per_read = (lerr_m.sum(axis=1) + 0.5 * diff.sum(axis=1)
                + 0.5 * (sigma * (dp @ u) + (dp @ v)))
    return float(np.where(read_mask, per_read, 0.0).sum())


def phase_region_sharded(frags: FragmentMatrix, cands: CandidateSet,
                         cfg: CallerConfig, seed: int,
                         apply_downsampling: bool = False,
                         devices: Optional[Sequence] = None):
    """Full iterative ``phase()`` for one giant region with its reads
    sharded over ``devices`` (a list; the same device may appear more than
    once). Returns the padded PhaseState as host numpy (the caller slices
    to true sizes), matching ``optimize._phase_region_padded_impl``
    semantics."""
    from ..phasing.kernels import TIE_TOL
    from ..phasing.optimize import (PhaseState, _bucket, block_flip_pass,
                                    compute_ld_blocks, init_genotype,
                                    init_haplotypes_ld)
    from .mesh import held_shards, sharded_ascent

    if not devices:
        raise ValueError("phase_region_sharded needs a list of devices")
    n_shards = len(devices)

    K0, I0 = frags.p.shape
    I = I0
    K = max(_bucket(max(1, K0)), n_shards)   # rows divisible across shards
    I_pad = _bucket(max(1, I0))
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, seed & 0x7FFFFFFF]))

    padKI = lambda a: np.pad(a, ((0, K - K0), (0, I_pad - I0)))
    padK = lambda a, v=0: np.pad(a, (0, K - K0), constant_values=v)
    padI = lambda a, v=0: np.pad(a, (0, I_pad - I0), constant_values=v)
    p_pad = padKI(frags.p).astype(np.int8)
    q_pad = padKI(frags.baseq).astype(np.uint8)
    ct_np = make_cell_tables_np(p_pad, q_pad)
    site_mask_np = padI(cands.for_phasing)
    ds = frags.downsampled if apply_downsampling else np.ones(K0, bool)
    read_base_np = padK(frags.for_phasing & ds)
    eta0 = padI(init_genotype(cands), 1).astype(np.float64)

    ld = compute_ld_blocks(cands, frags)
    delta0, conserved_np = init_haplotypes_ld(cands, ld, rng)
    delta0 = np.pad(delta0, (0, I_pad - I), constant_values=1).astype(np.float64)
    conserved_np = np.pad(conserved_np, (0, I_pad - I))
    sigma0 = np.where(rng.random(K) < 0.5, -1.0, 1.0)
    sigma0 = np.where(read_base_np, sigma0, 0.0)

    # each device gets its rows in compact form (2 bytes a cell) once for
    # the whole region and expands them there; the ascents' programs read
    # those tables where they lie, and are freed with the region
    with held_shards(devices, p_pad, q_pad, read_base_np,
                     site_mask_np) as shards:

        def ascend(keep_conserved: bool, sigma, delta,
                   eta) -> Tuple[PhaseState, float]:
            sg, dl, et, prob = sharded_ascent(shards, sigma, delta, eta,
                                              site_mask_np, conserved_np,
                                              False, keep_conserved)
            return (PhaseState(sg.cpu().numpy(), dl.cpu().numpy(),
                               et.cpu().numpy()), float(prob))

        best_st, best_prob = ascend(True, sigma0, delta0, eta0)

        exists_pad = np.zeros((K, I_pad), dtype=bool)
        exists_pad[:K0, :I] = frags.exists()
        st2 = block_flip_pass(ct_np, best_st, read_base_np, site_mask_np,
                              exists_pad, ld)
        sg2, dl2, et2 = (np.asarray(st2.sigma), np.asarray(st2.delta),
                         np.asarray(st2.eta))
        prob2 = _np_matvec_objective(ct_np, sg2, dl2, et2,
                                     read_base_np & (sg2 != 0), site_mask_np)
        if prob2 > best_prob + TIE_TOL:
            best_st, best_prob = st2, prob2

        # perturbation schedule (phase.rs:1198-1233), host loop + sharded
        # ascents
        n_rounds = I // 4 + 1
        for tidx in range(n_rounds):
            b_sg, b_dl, b_et = best_st
            lowv, highv = (1.0, -1.0) if tidx % 2 == 1 else (-1.0, 1.0)
            rg = rng.random(I_pad)
            delta = np.where(rg < 0.1, lowv, np.where(rg >= 0.9, highv, b_dl))
            st1, prob1 = ascend(False, b_sg, delta, b_et)
            if prob1 > best_prob + TIE_TOL:
                best_st, best_prob = st1, prob1
                b_sg, b_dl, b_et = best_st
            fl = (rng.random(K) < 0.1) & read_base_np & (b_sg != 0)
            sigma = np.where(fl, -b_sg, b_sg)
            st2, prob2 = ascend(False, sigma, b_dl, b_et)
            if prob2 > best_prob + TIE_TOL:
                best_st, best_prob = st2, prob2
    return PhaseState(*(np.asarray(a, np.float64) for a in best_st))
