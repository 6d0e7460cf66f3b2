"""Phasing optimizer: synchronous coordinate ascent + enumeration (torch).

Port of the per-region path of ``longcallr_tpu/phasing/optimize.py``
(``longcallR/src/phase.rs:810-1395``: cross_optimize, phase,
cross_optimize_by_block). The reference's per-read/per-SNP argmax loops are
synchronous (all reads update from the current SNP state, then all SNPs
from the new read state), so each half-step is one batched tensor call.
The ≤21-iteration ascent runs in chunks of ASCENT_CHUNK masked trips while
its continue flag is set; a batch of ascents (the enumeration path's
configs, a bucket's regions) runs as one loop in which each member freezes
when its own flag drops — the semantics of the JAX package's vmapped
``while_loop``. An ascent (``_ascent``) and the perturbation schedule keep
their state in tensors updated in place and are ``graphs.Program``s of
pieces and ``While`` loops (each ascent's chunks, the rounds), which the
card runs as one device program with its loops on the device — the
counterpart of the JAX package's ``jax.jit`` programs; the reference-form
ascent runs on the plain executor, one host read of the flag per chunk.

Execution modes (the JAX package's knobs): LONGCALLR_FAST_KERNELS=0
selects the reference-form ascent (the specification); the default
matvec-form ascent runs in split mode — f32-split Dp through the hand
kernels of ``cuda_kernels`` — on CUDA and in f64 on the CPU
(LONGCALLR_F32_KERNELS=0/1 forces either). Split-mode regions whose final
decision margins lie inside the split error bound are recomputed in f64 on
the same device (``N_F64_RERUNS`` counts them).

The host passes (LD blocks, BFS haplotype init, enumeration order, the
exact block-flip pass) are copied from the JAX package unchanged; the
perturbation randoms are drawn on the device by ``cuda_draws.round_draws``
from the keys of ``rng.prng_key`` (bit-identical to the JAX package's
``jax.random`` draws).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from ..config import CallerConfig

from ..ops.candidates import CandidateSet
from ..utils.device import Placement, phase_placement, resolve_device
from ..utils.spans import span, stage_add
from . import cuda_draws as CD
from . import graphs
from . import kernels_fast as KF
from . import rng as R
from .fragments import FragmentMatrix
from .kernels import (TIE_TOL, CellTables, CompactCells, as_tables, f64,
                      make_cell_tables_np, overall_probability, read_logliks,
                      sigma_q, snp_qs, snp_sums)


class PhaseState(NamedTuple):
    sigma: torch.Tensor   # [..., K] f64 in {-1,0,+1}
    delta: torch.Tensor   # [..., I] f64 in {-1,+1} (0 = unassigned)
    eta: torch.Tensor     # [..., I] f64 in {-1,0,+1}

    @classmethod
    def from_numpy(cls, sigma, delta, eta,
                   device=torch.device("cpu")) -> "PhaseState":
        t = lambda a: torch.tensor(np.asarray(a, np.float64), device=device)
        return cls(t(sigma), t(delta), t(eta))

    def to_numpy(self) -> "PhaseState":
        n = lambda a: (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a))
        return PhaseState(n(self.sigma), n(self.delta), n(self.eta))


# execution-mode switches (the JAX package's environment knobs)
USE_FAST_KERNELS = os.environ.get("LONGCALLR_FAST_KERNELS", "1") == "1"
_F32_ENV = os.environ.get("LONGCALLR_F32_KERNELS")
USE_F32_KERNELS: Optional[bool] = (None if _F32_ENV is None
                                   else _F32_ENV == "1")
# f32 safety net bound (LONGCALLR_F32_SAFETY=0 disables)
_SAFETY_ENV = os.environ.get("LONGCALLR_F32_SAFETY", "")
F32_SAFETY_TOL: float = (float(_SAFETY_ENV) if _SAFETY_ENV else 1e-3)

# process totals: split-mode regions whose split result was kept, and
# split-mode regions the safety net recomputed in f64 (_rerun_f64)
N_SPLIT_KEPT = 0
N_F64_RERUNS = 0
_count_lock = threading.Lock()


def _note(kept: bool) -> None:
    global N_SPLIT_KEPT, N_F64_RERUNS
    with _count_lock:
        if kept:
            N_SPLIT_KEPT += 1
        else:
            N_F64_RERUNS += 1


def _rerun_f64(rerun, *args) -> "PhaseState":
    """One recompute of the safety net in f64, ``rerun(*args)``, in its
    ``phase.f64_rerun`` span, counted there once: N_F64_RERUNS (a run's
    ``n_f64_reruns``) and the stage count ``phase_safety_recompute`` are
    the same number, the bucket members' and lone regions' reruns."""
    with span("phase.f64_rerun"):
        _note(kept=False)
        stage_add("phase_safety_recompute", 1)
        return rerun(*args)


def split_mode(device: torch.device) -> bool:
    """Split (f32 hi/lo Dp through the hand kernels) or f64: on for CUDA,
    off on the CPU, unless LONGCALLR_F32_KERNELS forces it."""
    if USE_F32_KERNELS is not None:
        return USE_F32_KERNELS
    return torch.device(device).type == "cuda"


def placed_split(placed: Placement) -> bool:
    """The mode of a routed phase problem: its device's, or for a problem
    placed in float64 (``placed.f64``) the host's, whatever its device:
    float64 unless LONGCALLR_F32_KERNELS forces split."""
    return split_mode(torch.device("cpu") if placed.f64 else placed.device)


# ---------------------------------------------------------------------------
# ascent loops (phase.rs:810-976)
# ---------------------------------------------------------------------------

def _select(mask, new: PhaseState, old: PhaseState) -> PhaseState:
    """Per-member select of batched states (mask [B] or scalar)."""
    def sel(a, b):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        return torch.where(m, a, b)
    return PhaseState(sel(new.sigma, old.sigma), sel(new.delta, old.delta),
                      sel(new.eta, old.eta))


# trips of an ascent between two reads of its continue flag (on the card a
# WHILE node's condition, in the plain executor a host read): the ascents of
# the perturbation schedule mostly end after two trips (one that changes the
# state and one that finds nothing to change)
ASCENT_CHUNK = 2
MAX_TRIPS = 21


def _assign(dst: PhaseState, src: PhaseState) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def _trips(st: PhaseState, active, count, sigma_step, snp_step,
           n: int) -> torch.Tensor:
    """``n`` masked trips of a batch of ascents, in place and without a host
    sync: a trip updates the members of ``active`` (their continue flags,
    bool of the batch shape) while ``count`` (int64 scalar) is below
    MAX_TRIPS, sets each such member's flag to its continue rule (any σ
    flip or any δ/η change) and counts itself where some member took it.
    Returns the bool scalar "some member still ascends". A first trip with
    every flag set is the JAX package's first ``while_loop`` trip; a trip
    in which no member is left changes nothing, so chunks of trips give the
    trips and states of the loop that stops at once."""
    for _ in range(n):
        live = active & (count < MAX_TRIPS)
        new_sigma, s_inc = sigma_step(st)
        new_delta, new_eta, d_inc = snp_step(st._replace(sigma=new_sigma))
        _assign(st, _select(live, PhaseState(new_sigma, new_delta, new_eta),
                            st))
        count.add_(live.any())
        active.copy_(torch.where(live, s_inc | d_inc, active))
    return active.any() & (count < MAX_TRIPS)


def _ascent_nodes(z, prepare) -> tuple:
    """One ascent (≤21 synchronous half-step pairs, each member of a batch
    stopping when its own continue flag drops) as program nodes over the
    namespace ``z``: "start" calls ``prepare`` (which sets ``z.steps``,
    (sigma_step, snp_step, objective)), copies the entry state ``z.entry``
    into ``z.cur``, sets every flag of ``z.active``, zeroes the trip count
    ``z.count`` and runs ASCENT_CHUNK trips; "ascent" runs ASCENT_CHUNK more
    while ``z.more`` is set; "objective" scores the final state into
    ``z.prob``. ``z.count`` ends as the most trips any member needed."""
    def climb():
        z.more.copy_(_trips(z.cur, z.active, z.count, z.steps[0],
                            z.steps[1], ASCENT_CHUNK))

    def start():
        prepare()
        _assign(z.cur, z.entry)
        z.active.fill_(True)
        z.count.zero_()
        climb()

    def score():
        z.prob.copy_(z.steps[2](z.cur))

    return (graphs.Piece("start", start),
            graphs.While(z.more, (graphs.Piece("ascent", climb),)),
            graphs.Piece("objective", score))


def _snp_decision(q1, q2, q3, q4, cov, st: PhaseState, site_mask, conserved,
                  with_genotype: bool, keep_conserved: bool):
    """(δ, η) argmax with the reference's tie rules, TIE_TOL-quantized
    (phase.rs:871-965). Returns (delta, eta, changed)."""
    upd = site_mask & (cov > 0)
    if keep_conserved:
        upd = upd & ~conserved
    if with_genotype:
        mx = torch.maximum(torch.maximum(q1, q2), torch.maximum(q3, q4))
        # tie order q1 > q2 > q3 > q4 (phase.rs:909-921)
        pick = torch.where(q1 >= mx - TIE_TOL, 0,
                           torch.where(q2 >= mx - TIE_TOL, 1,
                                       torch.where(q3 >= mx - TIE_TOL, 2, 3)))
    else:
        het = st.eta == 0
        pick = torch.where(het, torch.where(q2 > q1 + TIE_TOL, 1, 0),
                           torch.where(q4 > q3 + TIE_TOL, 3, 2))
    new_delta = torch.where(upd & (pick == 1), -st.delta, st.delta)
    new_eta = torch.where(
        upd, torch.where(pick <= 1, 0.0, torch.where(pick == 2, 1.0, -1.0)),
        st.eta)
    changed = ((new_delta != st.delta) | (new_eta != st.eta)).any(dim=-1)
    return new_delta, new_eta, changed


def _cross_optimize_loop(ct, st: PhaseState, read_base, site_mask,
                         conserved, with_genotype: bool,
                         keep_conserved: bool):
    """Reference-form ascent (the specification path): the ascent program
    walked by the plain executor."""
    st, prob, _ = _ascent(ct, st, read_base, site_mask, conserved,
                          with_genotype, keep_conserved, False, fast=False)
    return st, prob


def _first_member(rm0, lead: int):
    """The active-read set of the members that share each table (axis
    ``lead`` of ``rm0``, read_base & σ≠0); raises ValueError where they
    differ. A host sync: never inside a program's piece."""
    first = rm0.select(lead, 0)
    if not bool((rm0 == first.unsqueeze(lead)).all()):
        raise ValueError("ascents that share a table must share one "
                         "active-read set")
    return first


def _fast_tables_for(ct, read_base, sigma, site_mask, split: bool):
    """Tables for an ascent whose entry state is σ: the active-read set
    read_base & (σ≠0) is invariant under the ascent and the perturbation
    schedule (σ only flips sign), so a schedule builds them once.

    Cells [K,I] give one region's tables; cells [B,K,I] (with read_base and
    σ [B,K], site_mask [B,I]) give a bucket's, one table per member. A σ
    with one more axis than that (the enumeration configs) must share each
    region's set (``_first_member``; a program's piece passes the first
    member's σ, checked before the program runs)."""
    rm0 = read_base & (sigma != 0)
    lead = ct.p.dim() - 2
    if rm0.dim() - 1 > lead:
        rm0 = _first_member(rm0, lead)
    if split:
        if isinstance(ct, CompactCells):
            return KF.fast_tables32_from_compact(ct, rm0, site_mask)
        return KF.make_fast_tables32(as_tables(ct), rm0, site_mask)
    return KF.make_fast_tables(as_tables(ct), rm0, site_mask)


def _cross_optimize_fast_loop(ct, st: PhaseState, read_base, site_mask,
                              conserved, with_genotype: bool,
                              keep_conserved: bool, split: bool):
    st, prob, _ = _cross_optimize_fast_loop_it(
        ct, st, read_base, site_mask, conserved, with_genotype,
        keep_conserved, split)
    return st, prob


def _fast_steps(ft, read_base, sigma, site_mask, conserved,
                with_genotype: bool, keep_conserved: bool, split: bool):
    """The matvec-form ascent's half-steps and objective over the tables
    ``ft`` (kernels_fast): (sigma_step, snp_step, objective), each a
    function of a state."""
    rm0 = read_base & (sigma != 0)
    if split:
        read_ll, snp_s, objective = (KF.fast_read_logliks32,
                                     KF.fast_snp_sums32,
                                     KF.fast_overall_probability32)
    else:
        read_ll, snp_s, objective = (KF.fast_read_logliks, KF.fast_snp_sums,
                                     KF.fast_overall_probability)

    def sigma_step(st):
        lp, lm, ncell = read_ll(ft, st.delta, st.eta)
        upd = rm0 & (ncell > 0)
        q, qn = sigma_q(lp, lm, st.sigma)
        flip = upd & (qn > q + TIE_TOL)
        return torch.where(flip, -st.sigma, st.sigma), flip.any(dim=-1)

    def snp_step(st):
        sums = snp_s(ft, st.sigma, st.delta)
        return _snp_decision(*snp_qs(*sums), sums[4], st, site_mask,
                             conserved, with_genotype, keep_conserved)

    return sigma_step, snp_step, lambda st: objective(ft, *st)


def _spec_steps(ct, read_base, site_mask, conserved, with_genotype: bool,
                keep_conserved: bool):
    """The reference-form ascent's half-steps and objective (the
    specification path), as ``_fast_steps``."""
    ct = as_tables(ct)

    def sigma_step(st):
        lp, lm, ncell = read_logliks(ct, st.delta, st.eta, site_mask)
        upd = read_base & (st.sigma != 0) & (ncell > 0)
        q, qn = sigma_q(lp, lm, st.sigma)
        flip = upd & (qn > q + TIE_TOL)
        return torch.where(flip, -st.sigma, st.sigma), flip.any(dim=-1)

    def snp_step(st):
        read_mask = read_base & (st.sigma != 0)
        sums = snp_sums(ct, st.sigma, st.delta, read_mask, site_mask)
        return _snp_decision(*snp_qs(*sums), sums[4], st, site_mask,
                             conserved, with_genotype, keep_conserved)

    def objective(st):
        return overall_probability(ct, st.sigma, st.delta, st.eta,
                                   read_base & (st.sigma != 0), site_mask)

    return sigma_step, snp_step, objective


def _input_buffers(values: Dict[str, torch.Tensor], dev: torch.device):
    """A program's input buffers on ``dev``, one for every value (by its
    name, also as an attribute of a namespace ``z``). Returns (z, the
    buffers by name)."""
    z = SimpleNamespace()
    inputs = {}
    for k, v in values.items():
        inputs[k] = torch.empty(tuple(v.shape), dtype=v.dtype, device=dev)
        setattr(z, k, inputs[k])
    return z, inputs


def _ascent(ct, st: PhaseState, read_base, site_mask, conserved,
            with_genotype: bool, keep_conserved: bool, split: bool,
            fast: bool):
    """One ascent as one device program (``graphs.run``): the table build
    from the cells and the entry σ, the loop of ASCENT_CHUNK trips while
    some member ascends, and the objective (``_ascent_nodes``); the
    counterpart of the JAX package's compiled ascents (its ``while_loop``
    on the device, one issue, one read of the result). ``fast``: the
    matvec form (``_fast_steps``, split or f64) as a device program on the
    card; else the reference form (``_spec_steps``), never captured, which
    the plain executor walks.

    The tables carry the cells' leading axes (none for one region, [B] for
    a bucket); the state carries them and may carry one more, the members
    that share each table (the enumeration configs: σ [C,K] over cells
    [K,I], or [B,C,K] over [B,K,I] with read_base [B,K] and site_mask,
    conserved [B,I]): member m of region b reads table b. Such members
    must share the table's active-read set, which is checked here, before
    the program runs. Returns (state, prob, trips taken — the most any
    member needed — as an int64 scalar on the cells' device)."""
    dev = ct.p.device
    lead = ct.p.dim() - 2
    members = st.sigma.dim() - 1 > lead
    if members:
        _first_member(read_base.unsqueeze(lead) & (st.sigma != 0), lead)
    # a mask of the tables' shape gets the members' axis to broadcast over
    per = ((lambda t: t.unsqueeze(lead)) if members and lead
           else (lambda t: t))
    fields = type(ct)._fields
    values = {f"cell_{f}": getattr(ct, f) for f in fields}
    values.update(read_base=read_base, site_mask=site_mask,
                  conserved=conserved, sigma=st.sigma, delta=st.delta,
                  eta=st.eta)

    def make():
        z, inputs = _input_buffers(values, dev)
        z.entry = PhaseState(z.sigma, z.delta, z.eta)
        z.cur = PhaseState(*(torch.zeros_like(a) for a in z.entry))
        batch = tuple(st.sigma.shape[:-1])
        z.active = torch.zeros(batch, dtype=torch.bool, device=dev)
        z.prob = torch.zeros(batch, dtype=f64, device=dev)
        z.count = torch.zeros((), dtype=torch.int64, device=dev)
        z.more = torch.zeros((), dtype=torch.bool, device=dev)
        KF.constants_on(dev)

        def prepare():
            cells = type(ct)(*(getattr(z, f"cell_{f}") for f in fields))
            rb, sm, cons = per(z.read_base), per(z.site_mask), per(
                z.conserved)
            if fast:
                # one build for all members of a table: their active-read
                # set is the first member's
                ft = _fast_tables_for(
                    cells, z.read_base,
                    z.sigma.select(lead, 0) if members else z.sigma,
                    z.site_mask, split)
                if members and lead:
                    ft = KF.for_members(ft)
                z.steps = _fast_steps(ft, rb, z.sigma, sm, cons,
                                      with_genotype, keep_conserved, split)
            else:
                tabs = as_tables(cells)
                if members and lead:
                    tabs = CellTables(*(a.unsqueeze(lead) for a in tabs))
                z.steps = _spec_steps(tabs, rb, sm, cons, with_genotype,
                                      keep_conserved)

        return graphs.Program(dev, inputs, _ascent_nodes(z, prepare),
                              (*z.cur, z.prob, z.count))

    kind = ("ascent", type(ct).__name__, with_genotype, keep_conserved,
            split, fast, ASCENT_CHUNK)
    sg, dl, et, prob, trips = graphs.run(kind, dev, make, values,
                                         capture=fast)
    return PhaseState(sg, dl, et), prob, trips


def _cross_optimize_fast_loop_it(ct, st: PhaseState, read_base, site_mask,
                                 conserved, with_genotype: bool,
                                 keep_conserved: bool, split: bool):
    """Matvec-form ascent (kernels_fast): the reference's argmax/tie rules,
    two matvecs per iteration, as one device program (``_ascent``). With a
    leading region axis on everything the whole bucket ascends in the same
    launches. Returns (state, prob, trips as an int64 scalar)."""
    return _ascent(ct, st, read_base, site_mask, conserved, with_genotype,
                   keep_conserved, split, fast=True)


def cross_optimize_fast(ct, st: PhaseState, read_base, site_mask, conserved,
                        with_genotype: bool, keep_conserved: bool,
                        split: bool = False):
    """The matvec-form ascent whatever LONGCALLR_FAST_KERNELS says. Returns
    (final state, overall log10 probability)."""
    return _cross_optimize_fast_loop(ct, st, read_base, site_mask, conserved,
                                     with_genotype, keep_conserved, split)


def cross_optimize(ct, st: PhaseState, read_base, site_mask, conserved,
                   with_genotype: bool, keep_conserved: bool,
                   split: bool = False):
    """Alternating coordinate ascent, ≤21 iterations (phase.rs:810-976).
    Returns (final state, overall log10 probability)."""
    if USE_FAST_KERNELS:
        return _cross_optimize_fast_loop(ct, st, read_base, site_mask,
                                         conserved, with_genotype,
                                         keep_conserved, split)
    return _cross_optimize_loop(ct, st, read_base, site_mask, conserved,
                                with_genotype, keep_conserved)


# ---------------------------------------------------------------------------
# safety-net margin, objective, perturbation schedule
# ---------------------------------------------------------------------------

def _decision_gap(q, qn, upd, sums, site_mask) -> torch.Tensor:
    """The smaller of the reads' |q − q_flip| (where ``upd``) and the SNPs'
    top-2 gap among the four (δ, η) candidates of ``sums``."""
    inf = torch.full((), float("inf"), dtype=f64, device=q.device)
    sig_gap = torch.where(upd, (q - qn).abs(), inf).min(dim=-1).values
    qs = torch.stack(snp_qs(*sums))                       # [4, ..., I]
    upds = site_mask & (sums[4] > 0)
    mx = qs.max(dim=0).values
    am = qs.argmax(dim=0)
    ar4 = torch.arange(4, device=qs.device).reshape(4, *([1] * am.dim()))
    second = torch.where(ar4 == am[None], -inf, qs).max(dim=0).values
    snp_gap = torch.where(upds, mx - second, inf).min(dim=-1).values
    return torch.minimum(sig_gap, snp_gap)


def f64_decision_margin(ct, st: PhaseState, read_base,
                        site_mask) -> torch.Tensor:
    """Smallest decision gap at the final state, in exact f64 (reference
    form): per read the |q − q_flip| separation, per SNP the top-2 gap among
    the four (δ, η) candidates of the genotype re-argmax. A gap below the
    split error bound means a split-mode run may have taken another branch
    than f64 would — the safety net's trigger. (The final state need not be
    an argmax fixed point, so only a margin's magnitude says anything.)
    ``f64_decision_margin_fast`` is the matvec form the safety net runs."""
    ct = as_tables(ct)
    rm0 = read_base & (st.sigma != 0)
    lp, lm, ncell = read_logliks(ct, st.delta, st.eta, site_mask)
    q, qn = sigma_q(lp, lm, st.sigma)
    sums = snp_sums(ct, st.sigma, st.delta, rm0, site_mask)
    return _decision_gap(q, qn, rm0 & (ncell > 0), sums, site_mask)


def f64_decision_margin_fast(p8, q8, sigma, delta, eta, read_base,
                             site_mask) -> torch.Tensor:
    """Smallest decision gap at a final state, in exact f64 (matvec form):
    per read |q − q_flip|, per SNP the top-2 gap among the four (δ, η)
    candidates. A gap below F32_SAFETY_TOL means a split-mode run may have
    taken another branch than f64 would. With a leading region axis on
    every argument the margins come per region ([B])."""
    ct = as_tables(CompactCells(p8, q8))
    rm0 = read_base & (sigma != 0)
    ft = KF.make_fast_tables(ct, rm0, site_mask)
    lp, lm, ncell = KF.fast_read_logliks(ft, delta, eta)
    q, qn = sigma_q(lp, lm, sigma)
    sums = KF.fast_snp_sums(ft, sigma, delta)
    return _decision_gap(q, qn, rm0 & (ncell > 0), sums, site_mask)


def f64_decision_margin_batched(p8, q8, sigma, delta, eta, read_base,
                                site_mask) -> torch.Tensor:
    """Per-region margins of a whole bucket in one pass ([B] out): cells
    [B,K,I], σ and read_base [B,K], δ, η and site_mask [B,I]. The f64
    tables of the whole bucket are live at once (about 50 bytes a cell)."""
    if p8.dim() != 3:
        raise ValueError(f"a bucket's cells are [B,K,I], got {tuple(p8.shape)}")
    return f64_decision_margin_fast(p8, q8, sigma, delta, eta, read_base,
                                    site_mask)


def _overall_probability(ct, sigma, delta, eta, read_base, site_mask,
                         split: bool) -> torch.Tensor:
    """cal_overall_probability; in split mode via the split tables (the
    scale of the split-mode ascent objectives it is compared against)."""
    if USE_FAST_KERNELS and split and isinstance(ct, CompactCells):
        ft = _fast_tables_for(ct, read_base, sigma, site_mask, True)
        return KF.fast_overall_probability32(ft, sigma, delta, eta)
    ct = as_tables(ct)
    rm = read_base & (sigma != 0)
    return overall_probability(ct, sigma, delta, eta, rm, site_mask)


def _draw_rounds(I: int) -> int:
    """The rounds of draws a schedule makes: the JAX package's R_max =
    I // 4 + 1 at the padded width. A round past them reads the last, as
    JAX clamps its dynamic index."""
    return I // 4 + 1


def _schedule_namespace(values: Dict[str, torch.Tensor], lead: tuple, K: int,
                        I: int, cap: int, dev: torch.device):
    """A schedule program's tensors on ``dev``, on a namespace ``z``: a
    buffer for every input value (by its name), the best and the current
    state, the best prob, the ascent's continue flags and trip count, the
    round index ``t``, the flags "a round awaits its second keep-best"
    (``pending``), "an ascent goes on" (``more``) and "a round comes"
    (``go``), the trips of each ascent ([cap, 2]) and every round's draws.
    The emission tables go to ``dev`` too (``kernels_fast.constants_on``).
    Returns (z, the input buffers by name)."""
    z, inputs = _input_buffers(values, dev)
    R = _draw_rounds(I)
    e = lambda shape, dt=f64: torch.zeros(shape, dtype=dt, device=dev)
    z.best = PhaseState(e(lead + (K,)), e(lead + (I,)), e(lead + (I,)))
    z.cur = PhaseState(e(lead + (K,)), e(lead + (I,)), e(lead + (I,)))
    z.prob = e(lead)
    z.active = e(lead, torch.bool)
    z.count = e((), torch.int64)
    z.t = e(1, torch.int64)
    z.pending = e((), torch.bool)
    z.more = e((), torch.bool)
    z.go = e((), torch.bool)
    z.trips = e((cap, 2), torch.int64)
    z.rg = e((R,) + lead + (I,))
    z.fl = e((R,) + lead + (K,))
    KF.constants_on(dev)
    return z, inputs


def _schedule_start(z, best: PhaseState, prob) -> None:
    """The schedule's first step (inside a program's first piece): its
    state from ``best`` / ``prob``, every round's draws from ``z.keys``,
    and ``go`` for round 0."""
    _assign(z.best, best)
    z.prob.copy_(prob)
    _assign(z.cur, z.best)
    z.active.fill_(True)
    z.count.zero_()
    z.t.zero_()
    z.pending.fill_(False)
    z.trips.zero_()
    z.go.copy_(z.n_loop > 0)
    CD.round_draws(z.keys, z.rg.shape[0], z.rg.shape[-1], z.fl.shape[-1],
                   out=(z.rg, z.fl))


def _schedule_loop(z, rounds=None) -> tuple:
    """The perturbation schedule's loop (phase.rs:1198-1233) for one region
    or a bucket, as program nodes over the tensors of ``_schedule_namespace``
    (read and written in place; the ascent's steps are ``z.steps``,
    (sigma_step, snp_step, objective), set by the program's first piece):
    ``z.n_loop`` rounds of {δ resets → ascent → keep-best → σ flips →
    ascent → keep-best}. ``rounds`` (bucket only): each member's round
    count on the device — a member past its count keeps its state.

    The round loop and each ascent's loop are ``graphs.While`` loops, so a
    device program runs them on the device: "open" (the previous round's
    second keep-best and t + 1, where there is one, then δ resets and
    ASCENT_CHUNK trips of the first ascent), "flip" (its keep-best, σ flips,
    ASCENT_CHUNK trips of the second, and ``go`` for the next round) and
    "more" (ASCENT_CHUNK more trips) while an ascent is unfinished. The
    last round's second keep-best is "close". Round t reads draw
    min(t, R - 1), as the JAX package's clamped dynamic index does."""
    last = z.rg.shape[0] - 1

    def climb():
        z.more.copy_(_trips(z.cur, z.active, z.count, z.steps[0],
                            z.steps[1], ASCENT_CHUNK))

    def start(sigma, delta):
        _assign(z.cur, PhaseState(sigma, delta, z.best.eta))
        z.active.fill_(True)
        z.count.zero_()

    def keep(k: int, valid=None):
        p_new = z.steps[2](z.cur)
        better = p_new > z.prob + TIE_TOL
        if rounds is not None:
            better = better & (rounds > z.t)
        if valid is not None:
            better = better & valid
        _assign(z.best, _select(better, z.cur, z.best))
        z.prob.copy_(torch.where(better, p_new, z.prob))
        z.trips.select(1, k).index_copy_(0, z.t, z.count.reshape(1))

    def close_round():
        keep(1, z.pending)
        z.t.add_(z.pending)

    def drawn(draws):
        return draws.index_select(0, z.t.clamp(max=last)).squeeze(0)

    def open_round():
        close_round()
        z.pending.fill_(True)
        lowv = (z.t % 2).to(f64) * 2.0 - 1.0         # -1 on even rounds
        rg = drawn(z.rg)
        start(z.best.sigma, torch.where(rg < 0.1, lowv,
                                        torch.where(rg >= 0.9, -lowv,
                                                    z.best.delta)))
        climb()

    def flip_reads():
        keep(0)
        fl = (drawn(z.fl) < 0.1) & z.read_base & (z.best.sigma != 0)
        start(torch.where(fl, -z.best.sigma, z.best.sigma), z.best.delta)
        climb()
        z.go.copy_((z.t + 1 < z.n_loop).reshape(()))

    more = graphs.Piece("more", climb)
    return (graphs.While(z.go, (graphs.Piece("open", open_round),
                                graphs.While(z.more, (more,)),
                                graphs.Piece("flip", flip_reads),
                                graphs.While(z.more, (more,)))),
            graphs.Piece("close", close_round))


def _as_value(v, dtype) -> torch.Tensor:
    """A program input as a tensor of ``dtype`` (host data stays on the
    host until the program copies it)."""
    if isinstance(v, torch.Tensor):
        return v if v.dtype is dtype else v.to(dtype)
    return torch.as_tensor(np.asarray(v), dtype=dtype)


def _perturbation_impl(ct, st: PhaseState, best_st: PhaseState, best_prob,
                       read_base, site_mask, conserved, n_rounds: int, key,
                       split: bool, with_iters: bool):
    """Shared body of perturbation_phase and its _stats variant: one
    device program (``graphs.run``) of the table build, the draws and the
    schedule's loop."""
    if with_iters and not USE_FAST_KERNELS:
        raise RuntimeError("iteration accounting needs the fast-kernel ascent")
    K = st.sigma.shape[0]
    I = st.delta.shape[0]
    dev = st.sigma.device
    n_rounds = int(n_rounds)
    cap = max(_draw_rounds(I), n_rounds)
    fields = type(ct)._fields
    values = {f"cell_{f}": getattr(ct, f) for f in fields}
    values.update(read_base=read_base, site_mask=site_mask,
                  conserved=conserved, sigma=st.sigma,
                  best_sigma=best_st.sigma, best_delta=best_st.delta,
                  best_eta=best_st.eta,
                  best_prob=_as_value(best_prob, f64).reshape(()),
                  keys=_as_value(np.asarray(key, np.uint32).astype(np.int64),
                                 torch.int64),
                  n_loop=torch.tensor(n_rounds, dtype=torch.int64))

    def make():
        z, inputs = _schedule_namespace(values, (), K, I, cap, dev)

        def prologue():
            cells = type(ct)(*(getattr(z, f"cell_{f}") for f in fields))
            if USE_FAST_KERNELS:
                ft = _fast_tables_for(cells, z.read_base, z.sigma,
                                      z.site_mask, split)
                z.steps = _fast_steps(ft, z.read_base, z.sigma, z.site_mask,
                                      z.conserved, False, False, split)
            else:
                z.steps = _spec_steps(cells, z.read_base, z.site_mask,
                                      z.conserved, False, False)
            _schedule_start(z, PhaseState(z.best_sigma, z.best_delta,
                                          z.best_eta), z.best_prob)

        nodes = (graphs.Piece("start", prologue),) + _schedule_loop(z)
        return graphs.Program(dev, inputs, nodes,
                              (*z.best, z.prob, z.trips))

    kind = ("schedule", type(ct).__name__, split, USE_FAST_KERNELS,
            ASCENT_CHUNK, cap)
    sg, dl, et, prob, trips = graphs.run(kind, dev, make, values,
                                         capture=USE_FAST_KERNELS)
    b_st = PhaseState(sg, dl, et)
    if with_iters:
        return b_st, prob, int(trips[:n_rounds].sum())
    return b_st, prob


def perturbation_phase(ct, st: PhaseState, best_st: PhaseState, best_prob,
                       read_base, site_mask, conserved, n_rounds: int, key,
                       split: bool = False) -> Tuple[PhaseState, torch.Tensor]:
    """The perturbation schedule (phase.rs:1198-1233): n_rounds iterations
    of {10% SNP resets → ascent → keep-best → 10% read flips → ascent →
    keep-best}. ``key`` is a threefry key (rng.prng_key); the round
    randoms are drawn at the padded sizes, as in the JAX package."""
    return _perturbation_impl(ct, st, best_st, best_prob, read_base,
                              site_mask, conserved, n_rounds, key, split,
                              with_iters=False)


def perturbation_phase_stats(ct, st: PhaseState, best_st: PhaseState,
                             best_prob, read_base, site_mask, conserved,
                             n_rounds: int, key, split: bool = False):
    """perturbation_phase with ascent-trip accounting: returns (best state,
    best prob, total ascent trips across all 2·n_rounds ascents). Each trip
    is two passes over Dp (the rows and the cols matvec, kernels_fast.py;
    in split mode the two hand kernels): the count turns a measured wall
    time into bytes moved. Fast-kernel path only."""
    return _perturbation_impl(ct, st, best_st, best_prob, read_base,
                              site_mask, conserved, n_rounds, key, split,
                              with_iters=True)


def enumeration_order(n: int) -> np.ndarray:
    """All 2^n haplotype configs in the reference's enumeration order
    (phase.rs:1099-1106): start at all-ones; for each snp, append copies of
    every existing config with that snp flipped."""
    configs = [np.ones(n, dtype=np.int8)]
    for ti in range(n):
        for tj in range(len(configs)):
            c = configs[tj].copy()
            c[ti] = -c[ti]
            configs.append(c)
    assert len(configs) == 2 ** n
    return np.stack(configs) if n > 0 else np.ones((1, 0), dtype=np.int8)


# ---------------------------------------------------------------------------
# LD blocks (host): divide_snps_into_blocks (candidate.rs:615-747)
# ---------------------------------------------------------------------------

@dataclass
class LDInfo:
    pair_ld: Dict[Tuple[int, int], Tuple[float, int]]  # (score f32, weight)
    blocks: List[List[int]]          # each ≥1 snp, sorted; list sorted by min
    block_id: np.ndarray             # [I] int32, -1 if unblocked
    adj: Dict[int, List[int]]        # ld_graph adjacency (post weight filter)


def compute_ld_blocks(cands: CandidateSet, frags: FragmentMatrix,
                      ld_weight_threshold: int = 1) -> LDInfo:
    pair_ld: Dict[Tuple[int, int], Tuple[float, int]] = {}
    edges: Dict[Tuple[int, int], int] = {}
    nodes: Set[int] = set()
    ref_ok = ((cands.alleles[:, 0] == cands.ref_base)
              | (cands.alleles[:, 1] == cands.ref_base))
    # allele_freqs of (ref, alt) nonzero requirement (candidate.rs:670-676)
    ref_is_a1 = cands.alleles[:, 0] == cands.ref_base
    ref_frac = np.where(ref_is_a1, cands.allele_freqs[:, 0], cands.allele_freqs[:, 1])
    alt_frac = np.where(ref_is_a1, cands.allele_freqs[:, 1], cands.allele_freqs[:, 0])
    for (i, j), tbl in frags.ld_counts.items():
        if not (cands.for_phasing[i] and cands.for_phasing[j]):
            continue
        if not (ref_ok[i] and ref_ok[j]):
            continue
        if ref_frac[i] == 0 or alt_frac[i] == 0 or ref_frac[j] == 0 or alt_frac[j] == 0:
            continue
        c_rr, c_ra, c_ar, c_aa = int(tbl[0, 0]), int(tbl[0, 1]), int(tbl[1, 0]), int(tbl[1, 1])
        same = c_rr + c_aa
        opp = c_ra + c_ar
        c1, c2 = min(same, opp), max(same, opp)
        score = np.float32(c1) / np.float32(c2)  # NaN when c2 == 0
        if same > opp:
            sw = (float(score), c2)
        else:
            sw = (float(-score), -c2)
        pair_ld[(i, j)] = sw
        if score == 0.0:  # perfect LD (c1==0, c2>0); NaN fails
            edges[(i, j)] = sw[1]
            nodes.add(i)
            nodes.add(j)
    # weight filter (|w| < threshold dropped), nodes retained
    adj: Dict[int, List[int]] = {n: [] for n in nodes}
    for (i, j), w in edges.items():
        if abs(w) >= ld_weight_threshold:
            adj[i].append(j)
            adj[j].append(i)
    # connected components (deterministic: ordered by min node)
    block_id = np.full(cands.n, -1, dtype=np.int32)
    blocks: List[List[int]] = []
    seen: Set[int] = set()
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
    for bid, comp in enumerate(blocks):
        for u in comp:
            block_id[u] = bid
    for n in adj:
        adj[n].sort()
    return LDInfo(pair_ld=pair_ld, blocks=blocks, block_id=block_id, adj=adj)


def init_haplotypes_ld(cands: CandidateSet, ld: LDInfo,
                       rng: np.random.Generator,
                       ld_weight_threshold: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """init_haplotypes_LD2 (phase.rs:609-671): random ±1 everywhere, then
    BFS-consistent haplotypes inside each perfect-LD block. Returns
    (delta0[I] int8, conserved[I] bool)."""
    n = cands.n
    delta = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int8)
    conserved = np.zeros(n, dtype=bool)
    for comp in ld.blocks:
        if len(comp) < 2:
            continue
        root = comp[0]
        delta[root] = 1
        visited = [root]
        vset = {root}
        queue = [root]
        order = []
        while queue:
            u = queue.pop(0)
            order.append(u)
            for v in ld.adj.get(u, []):
                if v not in vset:
                    vset.add(v)
                    queue.append(v)
        for nx in order:
            if nx == root:
                continue
            for vi in visited:
                a, b = (vi, nx) if vi < nx else (nx, vi)
                sw = ld.pair_ld.get((a, b))
                if sw is None or sw[0] != 0.0:
                    continue
                w = sw[1]
                if w >= ld_weight_threshold:
                    delta[nx] = delta[vi]
                    break
                if w <= -ld_weight_threshold:
                    delta[nx] = -delta[vi]
                    break
            visited.append(nx)
        for u in comp:
            conserved[u] = True
    return delta, conserved


# ---------------------------------------------------------------------------
# Block flip pass: cross_optimize_by_block (phase.rs:1298-1394)
# ---------------------------------------------------------------------------

def _block_flip_fast(p8, q8, sigma, delta, eta, read_base, site_mask, bid):
    """Single-region device block flip over the split tables (split mode
    only — kernels_fast.fast_block_flip32)."""
    ft = _fast_tables_for(CompactCells(p8, q8), read_base, sigma, site_mask,
                          True)
    return KF.fast_block_flip32(ft, p8, sigma, delta, eta, site_mask, bid)


def block_flip_pass(ct_np: CellTables, st: PhaseState, read_base: np.ndarray,
                    site_mask: np.ndarray, exists: np.ndarray,
                    ld: LDInfo) -> PhaseState:
    """For every LD block: flip the whole block (and reads fully contained in
    it) if that raises the block objective. All decisions are computed
    against the current state, then applied together. Host numpy in, host
    numpy out."""
    ct = ct_np
    if not ld.blocks:
        return st
    sigma = np.asarray(st.sigma)
    delta = np.asarray(st.delta)
    eta = np.asarray(st.eta)
    K, I = exists.shape
    n_elems = exists.sum(axis=1)
    read_mask = read_base & (sigma != 0)
    pj = np.asarray(ct.p)
    l1m = np.asarray(ct.l1m)
    lerr = np.asarray(ct.lerr)
    m0 = site_mask[None, :] & exists & read_mask[:, None]
    x0 = sigma[:, None] * delta[None, :]
    s_match = np.where(m0, np.where(pj == x0, l1m, lerr), 0.0).sum(axis=0)
    s_flip = np.where(m0, np.where(pj == -x0, l1m, lerr), 0.0).sum(axis=0)
    s_refe = np.where(m0, np.where(pj == 1.0, l1m, lerr), 0.0).sum(axis=0)
    s_alte = np.where(m0, np.where(pj == -1.0, l1m, lerr), 0.0).sum(axis=0)
    cov = m0.sum(axis=0)
    # flip variant: sigma' = -sigma for reads fully inside the snp's block
    block_id = ld.block_id
    if block_id.shape[0] < I:
        block_id = np.pad(block_id, (0, I - block_id.shape[0]),
                          constant_values=-1)
    full_in = np.zeros((K,), dtype=np.int32) - 1  # block fully containing read
    for bid, comp in enumerate(ld.blocks):
        cols = np.asarray(comp)
        n_in = exists[:, cols].sum(axis=1)
        full = (n_in == n_elems) & (n_elems > 0)
        full_in[full] = bid
    flip_factor = np.ones((K, I), dtype=np.int8)
    blocked_cols = block_id >= 0
    ff_rows = full_in[:, None] == block_id[None, :]
    flip_factor[ff_rows & blocked_cols[None, :]] = -1
    # S'_match-flip: x = sigma*flip_factor*(-delta) per cell
    m = m0
    x_new = sigma[:, None] * flip_factor * (-delta[None, :])
    s_match_new = np.where(m, np.where(pj == x_new, l1m, lerr), 0.0).sum(axis=0)
    s_flip_new = np.where(m, np.where(pj == -x_new, l1m, lerr), 0.0).sum(axis=0)
    from .kernels import (PRIOR_HOMREF_LOG, PRIOR_HOMVAR_LOG, _LOG10_HALF,
                          _PRIOR_HET_BASE)
    ph = np.where(cov == 0, _PRIOR_HET_BASE,
                  _PRIOR_HET_BASE - cov * _LOG10_HALF)
    p_homref = PRIOR_HOMREF_LOG
    p_homvar = PRIOR_HOMVAR_LOG

    def q_of(sm, sf, e):
        n1 = np.where(e == 0, sm + ph, np.where(e == 1, s_refe + p_homref,
                                                s_alte + p_homvar))
        d = (s_alte + p_homvar) + (sm + ph) + (s_refe + p_homref) + (sf + ph)
        return 1.0 - n1 / d

    q_cur = q_of(s_match, s_flip, eta)
    q_new = q_of(s_match_new, s_flip_new, eta)
    new_delta = delta.copy()
    new_sigma = sigma.copy()
    phase_site_cells = exists & site_mask[None, :]
    for bid, comp in enumerate(ld.blocks):
        cols = np.asarray(comp)
        if q_new[cols].sum() > q_cur[cols].sum() + TIE_TOL:
            new_delta[cols] = -delta[cols]
            covers = phase_site_cells[:, cols].any(axis=1)
            flip_reads = (full_in == bid) & covers & read_mask
            new_sigma[flip_reads] = -sigma[flip_reads]
    return PhaseState(new_sigma.astype(np.float64),
                      new_delta.astype(np.float64), np.asarray(st.eta))


# ---------------------------------------------------------------------------
# phase(): top-level per-region optimization (phase.rs:1087-1296)
# ---------------------------------------------------------------------------

def init_genotype(cands: CandidateSet) -> np.ndarray:
    """variant_type → eta (phase.rs:682-691)."""
    vt = cands.variant_type
    return np.where(vt == 0, 1, np.where(vt == 1, 0, -1)).astype(np.int8)


def _bucket(n: int, lo: int = 8) -> int:
    """Round up to a power of two. The padded sizes also fix the shapes of
    the random draws, so they must match the JAX package's."""
    b = lo
    while b < n:
        b <<= 1
    return b


def phase_region(frags: FragmentMatrix, cands: CandidateSet,
                 cfg: CallerConfig, seed: int,
                 apply_downsampling: bool = False,
                 device: Optional[torch.device] = None) -> PhaseState:
    """Run the full phase() optimization for one region of a run on
    ``device`` (``None``: the CUDA device, and it raises where there is
    none). A region of little work is placed by utils/device.phase_placement
    (work = cells x rounds, the per-config ascents playing the rounds' part
    on the enumeration path): on a card run an enumeration region in
    float64 on the card, an iterative one on the host. A giant iterative
    region on a process with several cards goes to the reads-sharded ascent
    first (parallel/giant.py). Returns the final state as host numpy,
    sliced back to true sizes."""
    device = resolve_device() if device is None else torch.device(device)
    K0, I0 = frags.p.shape
    if I0 == 0:
        return PhaseState(np.zeros(K0), np.zeros(0), np.zeros(0))
    K, I_pad = _bucket(max(1, K0)), _bucket(max(1, I0))
    if I0 > cfg.max_enum_snps:
        # a giant iterative region goes to the reads-sharded ascent
        # (parallel/giant.py) when this process has several cards — the
        # reference serialises such loci on one rayon worker
        from ..parallel import giant
        if K * I_pad >= giant.GIANT_CELLS:
            devices = giant.reads_devices(device)
            if devices is not None:
                st = giant.phase_region_sharded(frags, cands, cfg, seed,
                                                apply_downsampling, devices)
                return PhaseState(st.sigma[:K0], st.delta[:I0], st.eta[:I0])
    enumeration = I0 <= cfg.max_enum_snps
    if enumeration:
        work = (1 << min(I0, 40)) * K * I_pad
    else:
        work = K * I_pad * (I0 // 4 + 1)
    placed = phase_placement(work, device, enumeration)
    return phase_region_on(frags, cands, cfg, seed, apply_downsampling,
                           placed.device, placed_split(placed))


def phase_region_on(frags: FragmentMatrix, cands: CandidateSet,
                    cfg: CallerConfig, seed: int, apply_downsampling: bool,
                    device: torch.device, split: bool) -> PhaseState:
    """phase() for one region on exactly ``device`` in the given mode, past
    the placement: what ``phase_region`` runs once it has routed, and what
    a bucket placed on the host, or in float64 on the card, runs for each
    of its members."""
    K0, I0 = frags.p.shape
    st = _phase_region_padded_impl(
        frags, cands, cfg, seed, apply_downsampling, K0, I0,
        _bucket(max(1, K0)), _bucket(max(1, I0)), torch.device(device),
        split).to_numpy()
    return PhaseState(st.sigma[:K0], st.delta[:I0], st.eta[:I0])


def phase_region_f64(frags: FragmentMatrix, cands: CandidateSet,
                     cfg: CallerConfig, seed: int, apply_downsampling: bool,
                     device: torch.device) -> PhaseState:
    """The safety net's recompute of a bucket's member: the whole phase()
    in f64 on ``device`` — what the per-region path does for a split-mode
    result whose margins are inside the bound (``_rerun_f64`` counts
    it)."""
    return _rerun_f64(phase_region_on, frags, cands, cfg, seed,
                      apply_downsampling, device, False)


def _phase_region_padded_impl(frags, cands, cfg, seed, apply_downsampling,
                              K0, I0, K, I_pad, device,
                              split: bool) -> PhaseState:
    I = I0  # logical candidate count (enumeration path keys off this)
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, seed & 0x7FFFFFFF]))
    padKI = lambda a: np.pad(a, ((0, K - K0), (0, I_pad - I0)))
    padK = lambda a, v=0: np.pad(a, (0, K - K0), constant_values=v)
    padI = lambda a, v=0: np.pad(a, (0, I_pad - I0), constant_values=v)
    on_dev = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    # compact transfer form: 2 bytes/cell; the f64 emission tables expand on
    # the device where needed
    p_pad = padKI(frags.p)
    q_pad = padKI(frags.baseq).astype(np.uint8)
    ct = CompactCells.from_numpy(p_pad, q_pad, device)
    site_mask_np = padI(cands.for_phasing)
    site_mask = on_dev(site_mask_np)
    ds = frags.downsampled if apply_downsampling else np.ones(K0, bool)
    read_base_np = padK(frags.for_phasing & ds)
    read_base = on_dev(read_base_np)
    eta0 = padI(init_genotype(cands), 1)
    net = USE_FAST_KERNELS and split and F32_SAFETY_TOL > 0

    def rerun_f64() -> PhaseState:
        return _rerun_f64(_phase_region_padded_impl, frags, cands, cfg, seed,
                          apply_downsampling, K0, I0, K, I_pad, device,
                          False)

    def margin_of(st: PhaseState) -> float:
        return float(f64_decision_margin_fast(ct.p, ct.q, st.sigma, st.delta,
                                              st.eta, read_base, site_mask))

    ld = compute_ld_blocks(cands, frags)

    if I <= cfg.max_enum_snps:
        # enumeration path (phase.rs:1097-1122)
        configs = enumeration_order(I).astype(np.float64)          # [C,I0]
        configs = np.pad(configs, ((0, 0), (0, I_pad - I)), constant_values=1.0)
        C = configs.shape[0]
        sig0 = np.where(rng.random((C, K)) < 0.5, -1.0, 1.0)
        sig0 = np.where(read_base_np[None, :], sig0, 0.0)
        cons = torch.zeros(I_pad, dtype=torch.bool, device=device)
        eta0_t = on_dev(eta0.astype(np.float64))
        # every config's active-read set read_base & σ≠0 is read_base itself:
        # each chunk's ascent program builds one set of tables for its
        # configs
        # chunk configs to bound peak memory (C·K·I intermediates)
        chunk = max(1, int(2 ** 24 // max(1, K * I_pad)))
        chunk = min(C, 1 << (chunk.bit_length() - 1))
        best_prob = -np.inf
        best_st = None
        best_idx = -1
        all_probs: List[np.ndarray] = []
        for c0 in range(0, C, chunk):
            sg = on_dev(sig0[c0:c0 + chunk])
            st0 = PhaseState(sg, on_dev(configs[c0:c0 + chunk]),
                             eta0_t.expand(sg.shape[0], I_pad).clone())
            sts, probs = cross_optimize(ct, st0, read_base, site_mask, cons,
                                        with_genotype=True,
                                        keep_conserved=False, split=split)
            probs = probs.cpu().numpy()
            all_probs.append(probs)
            # sequential keep-best with the tie-quantized rule: first in
            # enumeration order wins structural ties
            sel = -1
            for j in range(len(probs)):
                if probs[j] > best_prob + TIE_TOL:
                    best_prob = float(probs[j])
                    sel = j
            if sel >= 0:
                best_idx = c0 + sel
                best_st = PhaseState(*(a[sel] for a in sts))
        if net:
            # safety net, enumeration leg: the winner's f64 margins AND the
            # gap to every other config's objective (see the JAX package)
            pv = np.concatenate(all_probs)
            others = np.delete(pv, best_idx)
            cfg_gap = (best_prob - float(others.max())
                       if others.size else np.inf)
            # forced split mode has no exact rerun
            if (not USE_F32_KERNELS
                    and min(margin_of(best_st), cfg_gap) < F32_SAFETY_TOL):
                return rerun_f64()
        if split:
            _note(kept=True)
        return best_st

    # iterative path (phase.rs:1123-1294)
    delta0, conserved_np = init_haplotypes_ld(cands, ld, rng)
    delta0 = np.pad(delta0, (0, I_pad - I), constant_values=1)
    conserved_np = np.pad(conserved_np, (0, I_pad - I))
    conserved = on_dev(conserved_np)
    sigma0 = np.where(rng.random(K) < 0.5, -1.0, 1.0)
    sigma0 = np.where(read_base_np, sigma0, 0.0)
    st = PhaseState.from_numpy(sigma0, delta0, eta0, device)

    best_prob = -np.inf
    best_st = st

    def consider(st, prob):
        nonlocal best_prob, best_st
        p = float(prob)
        if p > best_prob + TIE_TOL:   # tie-quantized keep-best
            best_prob = p
            best_st = st

    st, prob = cross_optimize(ct, st, read_base, site_mask, conserved,
                              with_genotype=False, keep_conserved=True,
                              split=split)
    consider(st, prob)
    st = best_st

    # block flip: in split mode on the device over the split tables; a
    # region whose smallest per-block margin is inside the f32 envelope
    # takes the exact host pass
    st2 = None
    if USE_FAST_KERNELS and split:
        bid_pad = np.full(I_pad, -1, np.int32)
        bid_pad[:ld.block_id.shape[0]] = ld.block_id
        sg2, dl2, mg = _block_flip_fast(ct.p, ct.q, st.sigma, st.delta,
                                        st.eta, read_base, site_mask,
                                        on_dev(bid_pad))
        if float(mg) >= KF.F32_BF_TOL:
            st2 = PhaseState(sg2, dl2, st.eta)
    if st2 is None:
        exists_pad = np.zeros((K, I_pad), dtype=bool)
        exists_pad[:K0, :I] = frags.exists()
        ct_np = make_cell_tables_np(p_pad, q_pad)  # host pass: block flip only
        st2 = block_flip_pass(ct_np, st.to_numpy(), read_base_np,
                              site_mask_np, exists_pad, ld)
        del ct_np
        st2 = PhaseState.from_numpy(*st2, device=device)
    prob = _overall_probability(ct, st2.sigma, st2.delta, st2.eta,
                                read_base, site_mask, split)
    consider(st2, prob)
    st = best_st

    # perturbation rounds (phase.rs:1198-1233)
    n_rounds = I // 4 + 1
    key = R.prng_key(int(rng.integers(0, np.iinfo(np.int64).max,
                                      dtype=np.int64)))
    best_st, _ = perturbation_phase(ct, best_st, best_st, best_prob,
                                    read_base, site_mask, conserved,
                                    n_rounds, key, split)
    if net:
        # safety net: accept the split-mode result only when its f64
        # decision margins clear the bound; otherwise recompute in f64
        # forced split mode has no exact rerun
        if not USE_F32_KERNELS and margin_of(best_st) < F32_SAFETY_TOL:
            return rerun_f64()
    if split:
        _note(kept=True)
    return best_st
