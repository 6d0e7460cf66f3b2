"""The phase programs (phasing/graphs.py) against the JAX package's compiled
programs, on the CPU.

The port runs an ascent in chunks of ``optimize.ASCENT_CHUNK`` masked trips
with one read of the continue flag per chunk, and the fused bucket phase and
the schedule as ``graphs.Program``s: pieces over tensors updated in place
and ``While`` loops over them (``optimize._schedule_loop``,
``mesh._phase_fused``), which the card runs as one device program with
conditional WHILE nodes and the CPU through the plain executor. Here the
plain executor goes through the same seeded numpy inputs as the JAX
package's ``jax.jit`` programs (``while_loop`` ascents, ``fori_loop``
schedules, CPU backend, f64): states and trip counts equal, objectives to
1e-12 relative (summation order only), for chunks of 1 (every ascent
overruns its chunk and takes the "more" piece), 2 (the default) and 21 (one
chunk holds every trip). A dispatch-mode guard fails on any host sync inside
a piece: what the card could not capture. A stand-in program that "builds"
and "launches" on the CPU holds the census of the device form (pieces'
recorded launches times their runs, per row) and the cache of programs by
shape.
"""

import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from longcallr_tpu.parallel import mesh as JM
from longcallr_tpu.phasing import kernels as JK
from longcallr_tpu.phasing import optimize as JO
from longcallr_tpu_torch.parallel import mesh as TM
from longcallr_tpu_torch.phasing import cuda_kernels as CK
from longcallr_tpu_torch.phasing import graphs
from longcallr_tpu_torch.phasing import kernels as TK
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.phasing import rng as TR
from longcallr_tpu_torch.utils.adopt import adopt_batch

RTOL = 1e-12
CHUNKS = [1, 2, 21]


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(params=CHUNKS, ids=lambda n: f"chunk{n}")
def chunk(request, monkeypatch):
    monkeypatch.setattr(TO, "ASCENT_CHUNK", request.param)
    return request.param


# --- a host-sync guard ------------------------------------------------------

class _HostSync(AssertionError):
    pass


class SyncGuard(TorchDispatchMode):
    """Fails on every op that makes the host wait for the device or reads a
    tensor's values on the host: what a CUDA graph capture refuses."""

    SYNCS = ("aten._local_scalar_dense", "aten.item", "aten.is_nonzero",
             "aten.nonzero", "aten.masked_select", "aten.lift_fresh",
             "aten.lift_fresh_copy", "aten.equal", "aten.allclose")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in self.SYNCS:
            raise _HostSync(f"host sync in a step: {func}")
        if name in ("aten.index", "aten.index_put", "aten.index_put_"):
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(i is not None and i.dtype == torch.bool for i in idx):
                raise _HostSync(f"boolean-mask index in a step: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def guarded(monkeypatch):
    """Every piece the plain executor calls runs under SyncGuard; the flag
    reads between pieces (the host's) do not."""
    steps = []

    def call(self, piece):
        steps.append(piece.name)
        with SyncGuard():
            piece.fn()

    monkeypatch.setattr(graphs.Program, "_call", call)
    return steps


def test_the_guard_sees_a_sync():
    t = torch.ones(3)
    with pytest.raises(_HostSync):
        with SyncGuard():
            bool(t.sum() > 0)
    with pytest.raises(_HostSync):
        with SyncGuard():
            t[t > 0] = 2.0
    with pytest.raises(_HostSync):
        with SyncGuard():
            torch.tensor([1.0, 2.0])
    with SyncGuard():
        torch.where(t > 0, t, -t).sum()


# --- inputs -------------------------------------------------------------------

def _region(seed, K=64, I=16):
    r = np.random.default_rng(seed)
    p = r.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = r.integers(5, 31, size=(K, I)).astype(np.uint8)
    rb = r.random(K) < 0.9
    sm = r.random(I) < 0.95
    cons = r.random(I) < 0.2
    sg0 = np.where(rb, r.choice([-1.0, 1.0], K), 0.0)
    dl0 = r.choice([-1.0, 1.0], I)
    et0 = r.choice([-1.0, 0.0, 0.0, 1.0], I)
    return dict(p=p, q=q, rb=rb, sm=sm, cons=cons, sg0=sg0, dl0=dl0, et0=et0)


def _bucket(seed, B=3, K=64, I=16):
    regs = [_region(seed + 17 * b, K, I) for b in range(B)]
    d = {k: np.stack([r[k] for r in regs]) for k in regs[0]}
    d["bid"] = np.full((B, I), -1, np.int32)
    d["bid"][:, 0:3] = 0
    d["bid"][:, 5:8] = 1
    return d


def _jbatch(d):
    return JM.BatchedRegions(
        p=jnp.asarray(d["p"]), q=jnp.asarray(d["q"]),
        read_base=jnp.asarray(d["rb"]), site_mask=jnp.asarray(d["sm"]),
        conserved=jnp.asarray(d["cons"]))


def _tstate(d):
    return TO.PhaseState(_t(d["sg0"]), _t(d["dl0"]), _t(d["et0"]))


def _ascend_per_trip(st, sigma_step, snp_step):
    """The ascent loop as the port ran it before the chunked form: one host
    read of the continue flag per trip."""
    active = None
    trips = 0
    for _ in range(21):
        trips += 1
        new_sigma, s_inc = sigma_step(st)
        st1 = st._replace(sigma=new_sigma)
        new_delta, new_eta, d_inc = snp_step(st1)
        st1 = st1._replace(delta=new_delta, eta=new_eta)
        go = s_inc | d_inc
        if active is None:
            st, active = st1, go
        else:
            st, active = TO._select(active, st1, st), active & go
        if not bool(active.any()):
            break
    return st, trips


_jax_ascent = jax.jit(JO._cross_optimize_fast_loop_it,
                      static_argnames=("with_genotype", "keep_conserved"))


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# --- the chunked ascent ---------------------------------------------------------

@pytest.mark.parametrize("keep_conserved,with_genotype",
                         [(True, False), (False, True), (False, False)])
def test_chunked_ascent_of_one_region(chunk, keep_conserved, with_genotype):
    """One region: the chunked ascent equals the per-trip loop and the JAX
    package's while_loop in states and trips; objective to 1e-12."""
    d = _region(3)
    cc = TK.CompactCells.from_numpy(d["p"], d["q"])
    rb, sm, cons = _t(d["rb"]), _t(d["sm"]), _t(d["cons"])
    st0 = _tstate(d)
    got, prob, trips = TO._cross_optimize_fast_loop_it(
        cc, st0, rb, sm, cons, with_genotype, keep_conserved, False)
    ft = TO._fast_tables_for(cc, rb, st0.sigma, sm, False)
    sigma_step, snp_step, objective = TO._fast_steps(
        ft, rb, st0.sigma, sm, cons, with_genotype, keep_conserved, False)
    old, old_trips = _ascend_per_trip(st0, sigma_step, snp_step)
    jst, jprob, jtrips = _jax_ascent(
        JK.make_cell_tables(d["p"], d["q"]),
        JO.PhaseState(*(jnp.asarray(d[k]) for k in ("sg0", "dl0", "et0"))),
        jnp.asarray(d["rb"]), jnp.asarray(d["sm"]), jnp.asarray(d["cons"]),
        with_genotype=with_genotype, keep_conserved=keep_conserved)
    _same(got, old)
    _same(got, jst)
    assert int(trips) == old_trips == int(jtrips) >= 2
    assert float(prob) == float(objective(old))
    np.testing.assert_allclose(float(prob), float(jprob), rtol=RTOL)


@pytest.mark.parametrize("split", [False, True], ids=["f64", "split"])
def test_chunked_ascent_of_a_bucket(chunk, split):
    """A bucket of 3: each member freezes on its own flag; trips are the
    most any member took (the per-member JAX while_loops' maximum); states
    equal the JAX package's vmapped ascent (f64) and the per-trip loop
    (both modes, bit for bit)."""
    d = _bucket(5)
    cc = TK.CompactCells.from_numpy(d["p"], d["q"])
    rb, sm, cons = _t(d["rb"]), _t(d["sm"]), _t(d["cons"])
    st0 = _tstate(d)
    got, prob, trips = TO._cross_optimize_fast_loop_it(
        cc, st0, rb, sm, cons, False, True, split)
    ft = TO._fast_tables_for(cc, rb, st0.sigma, sm, split)
    sigma_step, snp_step, objective = TO._fast_steps(
        ft, rb, st0.sigma, sm, cons, False, True, split)
    old, old_trips = _ascend_per_trip(st0, sigma_step, snp_step)
    _same(got, old)
    assert int(trips) == old_trips
    assert torch.equal(prob, objective(old))
    if split:
        return
    want = JM.batched_cross_optimize(
        _jbatch(d), *(jnp.asarray(d[k]) for k in ("sg0", "dl0", "et0")),
        keep_conserved=True, with_genotype=False)
    _same(got, want[:3])
    np.testing.assert_allclose(prob.numpy(), np.asarray(want[3]), rtol=RTOL)
    each = [int(_jax_ascent(
        JK.make_cell_tables(d["p"][b], d["q"][b]),
        JO.PhaseState(*(jnp.asarray(d[k][b]) for k in ("sg0", "dl0", "et0"))),
        jnp.asarray(d["rb"][b]), jnp.asarray(d["sm"][b]),
        jnp.asarray(d["cons"][b]), with_genotype=False,
        keep_conserved=True)[2]) for b in range(3)]
    assert int(trips) == max(each) and min(each) >= 1


def _plain_ascent(st0, sigma_step, snp_step):
    """The ascent program's nodes (optimize._ascent_nodes) over stand-in
    half-steps, walked by the plain executor: (state, trips)."""
    lead = st0.sigma.shape[:-1]
    z = SimpleNamespace(
        entry=st0, cur=TO.PhaseState(*(torch.zeros_like(a) for a in st0)),
        active=torch.zeros(lead, dtype=torch.bool),
        prob=torch.zeros(lead, dtype=torch.float64),
        count=torch.zeros((), dtype=torch.int64),
        more=torch.zeros((), dtype=torch.bool))

    def prepare():
        z.steps = (sigma_step, snp_step, lambda st: st.delta.sum(-1))

    prog = graphs.Program(torch.device("cpu"), {},
                          TO._ascent_nodes(z, prepare),
                          (*z.cur, z.prob, z.count))
    prog.run_plain()
    return TO.PhaseState(*prog.outputs[:3]), prog.outputs[4]


def test_trip_cap_and_frozen_members(chunk):
    """Stand-in half-steps through the ascent program's nodes: member 0
    never converges and stops at the 21-trip cap, member 1 converges after
    its third trip and keeps that state."""
    sigma0 = torch.ones(2, 4, dtype=torch.float64)
    st0 = TO.PhaseState(sigma0, torch.zeros(2, 3, dtype=torch.float64),
                        torch.zeros(2, 3, dtype=torch.float64))

    def sigma_step(st):
        return -st.sigma, torch.tensor([True, False])

    def snp_step(st):
        return st.delta + 1.0, st.eta, st.delta[:, 0] < 2.0

    got, trips = _plain_ascent(st0, sigma_step, snp_step)
    old, old_trips = _ascend_per_trip(st0, sigma_step, snp_step)
    assert int(trips) == old_trips == 21
    _same(got, old)
    assert got.delta[0, 0] == 21 and got.delta[1, 0] == 3
    assert torch.equal(got.sigma[0], -sigma0[0])
    assert torch.equal(st0.sigma, sigma0)        # the input is not written


def test_chunked_ascent_makes_no_host_sync(chunk):
    d = _bucket(6)
    cc = TK.CompactCells.from_numpy(d["p"], d["q"])
    rb, sm, cons = _t(d["rb"]), _t(d["sm"]), _t(d["cons"])
    st = _tstate(d)
    ft = TO._fast_tables_for(cc, rb, st.sigma, sm, True)
    sigma_step, snp_step, _ = TO._fast_steps(ft, rb, st.sigma, sm, cons,
                                             False, True, True)
    active = torch.ones(3, dtype=torch.bool)
    count = torch.zeros((), dtype=torch.int64)
    with SyncGuard():
        more = TO._trips(st, active, count, sigma_step, snp_step, chunk)
    assert int(count) == min(chunk, 21) or not bool(more)


# --- the schedule --------------------------------------------------------------

def _one_region_schedule(seed=9, K=96, I=24):
    """A region after its first ascent in the JAX package, and the same in
    the port's types."""
    r = np.random.default_rng(seed)
    p = r.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = r.integers(10, 31, size=(K, I)).astype(np.uint8)
    rb = r.random(K) < 0.9
    sig0 = np.where(rb, r.choice([-1.0, 1.0], K), 0.0)
    dl0 = r.choice([-1.0, 1.0], I)
    sm, cons = np.ones(I, bool), np.zeros(I, bool)
    jct = JK.make_cell_tables(p, q)
    jst1, jprob = JO.selected_loop()(
        jct, JO.PhaseState(jnp.asarray(sig0), jnp.asarray(dl0), jnp.zeros(I)),
        jnp.asarray(rb), jnp.asarray(sm), jnp.asarray(cons), False, False)
    jargs = (jct, jst1, jst1, jprob, jnp.asarray(rb), jnp.asarray(sm),
             jnp.asarray(cons), jnp.int32(I // 4 + 1))
    tst1 = TO.PhaseState.from_numpy(*(np.asarray(a) for a in jst1))
    targs = (TK.CompactCells.from_numpy(p, q), tst1, tst1, float(jprob),
             _t(rb), _t(sm), _t(cons), I // 4 + 1)
    return jargs, targs


def test_perturbation_phase_matches_jax(chunk, guarded):
    seed = 555666777888
    jargs, targs = _one_region_schedule()
    jb, jp = JO.perturbation_phase(*jargs, jax.random.PRNGKey(seed))
    tb, tp = TO.perturbation_phase(*targs, TR.prng_key(seed))
    _same(tb, jb)
    np.testing.assert_allclose(float(tp), float(jp), rtol=RTOL)
    assert guarded.count("open") == targs[-1]
    if chunk == 1:          # an ascent of two or more trips overruns
        assert "more" in guarded
    if chunk == 21:         # one chunk holds every trip
        assert "more" not in guarded


def test_perturbation_phase_stats_matches_jax(chunk, guarded):
    seed = 111222333444
    jargs, targs = _one_region_schedule(seed=10)
    jb, jp, jit = JO.perturbation_phase_stats(*jargs,
                                              jax.random.PRNGKey(seed))
    tb, tp, tit = TO.perturbation_phase_stats(*targs, TR.prng_key(seed))
    _same(tb, jb)
    np.testing.assert_allclose(float(tp), float(jp), rtol=RTOL)
    assert tit == int(jit) >= 2 * targs[-1]


def _ascended(d):
    sg, dl, et, pr = JM.batched_cross_optimize(
        _jbatch(d), *(jnp.asarray(d[k]) for k in ("sg0", "dl0", "et0")))
    return tuple(np.asarray(a) for a in (sg, dl, et, pr))


def _keys(B, base):
    seeds = [base + 1000003 * b for b in range(B)]
    return (jnp.stack([jax.random.PRNGKey(s) for s in seeds]),
            [TR.prng_key(s) for s in seeds])


@pytest.mark.parametrize("stats", [False, True], ids=["phase", "stats"])
def test_batched_perturbation_phase_matches_jax(chunk, guarded, stats):
    """Mixed round counts: a member past its count keeps its state while the
    others go on; with stats, the summed trips of the slowest member per
    ascent equal the JAX program's."""
    d = _bucket(21)
    I = d["p"].shape[2]
    sg, dl, et, pr = _ascended(d)
    n_rounds = np.array([I // 4 + 1, 2, 3])
    jkeys, tkeys = _keys(3, base=31)
    jargs = (_jbatch(d), *map(jnp.asarray, (sg, dl, et, pr)),
             jnp.asarray(n_rounds.astype(np.int32)), jkeys)
    targs = (adopt_batch(_jbatch(d), torch.device("cpu")),
             *map(_t, (sg, dl, et, pr)), n_rounds, tkeys)
    if stats:
        want = JM.batched_perturbation_phase_stats(*jargs)
        got = TM.batched_perturbation_phase_stats(*targs)
        assert int(got[4]) == int(want[4]) > 0
    else:
        want = JM.batched_perturbation_phase(*jargs)
        got = TM.batched_perturbation_phase(*targs)
    _same(got[:3], want[:3])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=RTOL)
    assert guarded.count("open") == n_rounds.max()


def test_batched_phase_fused_matches_jax(chunk, guarded, monkeypatch):
    """The bucket's fused phase in split mode (both packages forced into
    it): states equal, sums within the JAX package's own 1e-4 bound."""
    monkeypatch.setattr(JO, "USE_F32_KERNELS", True)
    monkeypatch.setattr(TO, "USE_F32_KERNELS", True)
    jax.clear_caches()
    try:
        d = _bucket(23)
        I = d["p"].shape[2]
        n_rounds = np.array([I // 4 + 1, 2, I // 4 + 1])
        jkeys, tkeys = _keys(3, base=5)
        args = [d[k] for k in ("sg0", "dl0", "et0", "bid")]
        want = JM.batched_phase_fused(
            _jbatch(d), *map(jnp.asarray, args),
            jnp.asarray(n_rounds.astype(np.int32)), jkeys)
        got = TM.batched_phase_fused(
            adopt_batch(_jbatch(d), torch.device("cpu")), *map(_t, args),
            n_rounds, tkeys)
    finally:
        jax.clear_caches()
    _same(got[:3], want[:3])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=0,
                               atol=1e-4)
    assert guarded.count("open") == I // 4 + 1


def test_spec_loop_schedule_is_not_captured(monkeypatch):
    """LONGCALLR_FAST_KERNELS=0: the schedule takes the chunked ascent of
    the reference form, and its program is never captured."""
    made = []
    run = graphs.run

    def spy(kind, device, make, values, capture=True):
        made.append(capture)
        return run(kind, device, make, values, capture)

    monkeypatch.setattr(graphs, "run", spy)
    monkeypatch.setattr(TO, "USE_FAST_KERNELS", False)
    monkeypatch.setattr(JO, "USE_FAST_KERNELS", False)
    seed = 42424242
    jax.clear_caches()      # the JAX package resolves the mode at trace time
    try:
        jargs, targs = _one_region_schedule(seed=12, K=48, I=12)
        jb, jp = JO.perturbation_phase(*jargs, jax.random.PRNGKey(seed))
    finally:
        jax.clear_caches()
    tb, tp = TO.perturbation_phase(*targs, TR.prng_key(seed))
    _same(tb, jb)
    np.testing.assert_allclose(float(tp), float(jp), rtol=RTOL)
    assert made == [False]


# --- rounds past the drawn ones ---------------------------------------------------

def test_perturbation_phase_past_the_drawn_rounds_matches_jax(chunk):
    """n_rounds = I // 4 + 3: the JAX package clamps its dynamic index into
    the I // 4 + 1 rounds it drew, so the last two rounds reuse the last
    round's draws; the port's program clamps the same way."""
    seed = 98765
    jargs, targs = _one_region_schedule(seed=13, K=64, I=16)
    n = 16 // 4 + 3
    jb, jp, jit = JO.perturbation_phase_stats(*jargs[:-1], jnp.int32(n),
                                              jax.random.PRNGKey(seed))
    tb, tp, tit = TO.perturbation_phase_stats(*targs[:-1], n,
                                              TR.prng_key(seed))
    _same(tb, jb)
    np.testing.assert_allclose(float(tp), float(jp), rtol=RTOL)
    assert tit == int(jit) >= 2 * n


@pytest.mark.parametrize("stats", [False, True], ids=["phase", "stats"])
def test_batched_perturbation_phase_past_the_drawn_rounds_matches_jax(stats):
    """One member of a bucket runs I // 4 + 3 rounds, past the I // 4 + 1
    drawn: it reads the last round's draws again, as the JAX program's
    clamped index does, and the others keep their state past their
    counts."""
    d = _bucket(29)
    I = d["p"].shape[2]
    sg, dl, et, pr = _ascended(d)
    n_rounds = np.array([2, I // 4 + 3, 3])
    jkeys, tkeys = _keys(3, base=77)
    jargs = (_jbatch(d), *map(jnp.asarray, (sg, dl, et, pr)),
             jnp.asarray(n_rounds.astype(np.int32)), jkeys)
    targs = (adopt_batch(_jbatch(d), torch.device("cpu")),
             *map(_t, (sg, dl, et, pr)), n_rounds, tkeys)
    if stats:
        want = JM.batched_perturbation_phase_stats(*jargs)
        got = TM.batched_perturbation_phase_stats(*targs)
        assert int(got[4]) == int(want[4]) > 0
    else:
        want = JM.batched_perturbation_phase(*jargs)
        got = TM.batched_perturbation_phase(*targs)
    _same(got[:3], want[:3])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=RTOL)


# --- the program's census and cache --------------------------------------------------

def test_runner_on_the_cpu_calls_each_step():
    """The plain executor on the CPU: the pieces in order, a loop's body
    while its flag (read on the host before each turn) is set, and the body
    runs of each loop counted."""
    seen = []
    x = torch.zeros((), dtype=torch.int64)
    flag = torch.zeros((), dtype=torch.bool)

    def first():
        seen.append("first")
        x.zero_()
        flag.fill_(True)

    def body():
        seen.append("body")
        x.add_(1)
        flag.copy_(x < 3)

    CK.reset_launches()
    prog = graphs.Program(torch.device("cpu"), {}, (
        graphs.Piece("first", first),
        graphs.While(flag, (graphs.Piece("body", body),)),
        graphs.Piece("last", lambda: seen.append("last"))), (x,))
    assert prog.run_plain() == [3]
    assert seen == ["first", "body", "body", "body", "last"]
    assert int(x) == 3
    assert CK.GRAPHS["flag_reads"] == 4 and CK.GRAPHS["launches"] == 0
    runs = prog.piece_runs([3])
    assert [runs[id(p)] for p in prog.pieces] == [1, 3, 1]
    CK.reset_launches()


class _StandIn(graphs.Program):
    """A program that "builds" and "launches" on the CPU: the build records
    each piece's launches as a capture does, and a launch runs the plain
    executor with the launches recorded, not counted, so that only the
    census of the device form counts them."""

    def build(self):
        for p in self.pieces:
            with CK.recording() as launches:
                p.fn()
            self._captured[id(p)] = (None, launches)
        return {"capture_seconds": 0.0, "instantiate_seconds": 0.0,
                "captures": len(self.pieces)}

    def _execute(self):
        with CK.recording():
            runs = self.run_plain()
        # the plain executor reads a flag where the device sets a condition
        return tuple(o.clone() for o in self.outputs), runs, self.flag_reads


def _launch_each():
    """What a piece that calls each wrapper once counts on the card."""
    hi = torch.zeros(2, 8, 4, dtype=torch.float32)
    CK._count("dual_matvec_rows", hi, 1, 0)
    CK._count("matvec_cols", hi, 1, 0)


def _counting_program(n: int) -> _StandIn:
    """A stand-in program of a first piece and a loop whose body runs ``n``
    times, each piece calling each wrapper once."""
    i = torch.zeros((), dtype=torch.int64)
    flag = torch.zeros((), dtype=torch.bool)

    def first():
        _launch_each()
        i.zero_()
        flag.fill_(n > 0)

    def body():
        _launch_each()
        i.add_(1)
        flag.copy_(i < n)

    return _StandIn(torch.device("cpu"), {}, (
        graphs.Piece("first", first),
        graphs.While(flag, (graphs.Piece("body", body),))), (i,))


@pytest.mark.parametrize("n", [1, 5])
def test_replays_add_the_captured_launches_for_the_row(n):
    """A program's run counts each piece's recorded launches times its runs
    (the first piece once, the body's n times), for the row of the thread
    that ran it; the build counts nothing."""
    CK.reset_launches()
    out = {}

    def row():
        CK.set_launch_row(3)
        try:
            prog = _counting_program(n)
            prog.build()
            out["built"] = dict(CK.LAUNCHES)
            out["runs"] = prog.launch()[1]
        finally:
            CK.set_launch_row(None)

    th = threading.Thread(target=row)
    th.start()
    th.join()
    try:
        assert out["built"] == {"dual_matvec_rows": 0, "matvec_cols": 0}
        assert out["runs"] == [n]
        assert CK.LAUNCHES == {"dual_matvec_rows": n + 1,
                               "matvec_cols": n + 1}
        assert CK.LAUNCHES_BY_ROW == {3: dict(CK.LAUNCHES)}
        assert CK.LAUNCHES_BY_DEVICE == {0: dict(CK.LAUNCHES)}
        assert CK.LAUNCH_SHAPES["matvec_cols"] == {(2, 8, 4, 1)}
        assert CK.GRAPHS["launches"] == 1 and CK.GRAPHS["body_runs"] == n
        assert CK.GRAPHS["condition_sets"] == n + 1
        assert CK.GRAPHS["flag_reads"] == n + 1   # the stand-in's own
        assert CK.GRAPH_LAUNCHES == {"dual_matvec_rows": n + 1,
                                     "matvec_cols": n + 1}
    finally:
        CK.reset_launches()
    assert CK.GRAPHS == {"launches": 0, "builds": 0, "captures": 0,
                         "capture_seconds": 0.0, "instantiate_seconds": 0.0,
                         "bytes_held": 0, "evicted": 0, "body_runs": 0,
                         "condition_sets": 0, "flag_reads": 0}
    assert CK.GRAPH_LAUNCHES == {"dual_matvec_rows": 0, "matvec_cols": 0}


def test_replays_from_many_threads_lose_no_count():
    """Rows of a mesh run their programs in threads of their own: 16
    threads, each its own stand-in program and row, with a short switch
    interval; no run and no launch is lost."""
    import sys
    CK.reset_launches()
    n_threads, n = 16, 200
    errors = []

    def row(r):
        try:
            CK.set_launch_row(r)
            prog = _counting_program(n)
            prog.build()
            prog.launch()
        except Exception as exc:            # reported below
            errors.append(exc)
        finally:
            CK.set_launch_row(None)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=row, args=(r,))
                   for r in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads) and not errors
        each = {"dual_matvec_rows": n + 1, "matvec_cols": n + 1}
        assert CK.LAUNCHES_BY_ROW == {r: each for r in range(n_threads)}
        assert CK.GRAPHS["launches"] == n_threads
        assert CK.GRAPHS["body_runs"] == n_threads * n
        assert CK.GRAPH_LAUNCHES == {k: n_threads * (n + 1) for k in each}
    finally:
        sys.setswitchinterval(interval)
        CK.reset_launches()


def test_body_runs_count_the_chunks_run(chunk, monkeypatch):
    """The census of a device program counts a piece's launches once per
    run that the loops' body-run counters give it: on the plain executor,
    that count equals the calls each piece of the fused bucket phase
    really got, chunks of trips included."""
    calls, seen = {}, []
    call = graphs.Program._call
    plain = graphs.Program.run_plain

    def counting(self, piece):
        calls[id(piece)] = calls.get(id(piece), 0) + 1
        call(self, piece)

    def keep(self):
        runs = plain(self)
        seen.append((self, runs))
        return runs

    monkeypatch.setattr(graphs.Program, "_call", counting)
    monkeypatch.setattr(graphs.Program, "run_plain", keep)
    monkeypatch.setattr(TO, "USE_F32_KERNELS", True)
    d = _bucket(31)
    I = d["p"].shape[2]
    jkeys, tkeys = _keys(3, base=9)
    args = [d[k] for k in ("sg0", "dl0", "et0", "bid")]
    CK.reset_launches()
    TM.batched_phase_fused(adopt_batch(_jbatch(d), torch.device("cpu")),
                           *map(_t, args), np.array([I // 4 + 1, 2, 3]),
                           tkeys)
    (prog, runs), = seen
    # the set-condition kernel stands where the plain executor reads a flag
    assert prog.condition_sets(runs) == CK.GRAPHS["flag_reads"] == \
        (1 + runs[0]) + (1 + runs[1]) + 2 * runs[1] + runs[2] + runs[3]
    CK.reset_launches()
    names = {p.name: calls.get(id(p), 0) for p in prog.pieces}
    assert prog.piece_runs(runs) == {id(p): names[p.name]
                                     for p in prog.pieces}
    assert names["tables"] == names["blockflip"] == names["close"] == 1
    assert names["open"] == names["flip"] == I // 4 + 1 == runs[1]
    # a chunk runs in "tables" (the first ascent's first), in every "open"
    # and "flip", and once for every turn of an ascent's loop
    assert names["ascent"] == runs[0]
    assert names["more"] == runs[2] + runs[3]
    if chunk == 21:
        assert names["ascent"] == names["more"] == 0


def _standin_device(monkeypatch):
    """Make graphs.run take its device-program path on the CPU with the
    stand-in's build and launch."""
    monkeypatch.setattr(graphs, "_device_program",
                        lambda device, capture: capture and graphs.ENABLED)
    monkeypatch.setattr(graphs.Program, "build", _StandIn.build)
    monkeypatch.setattr(graphs.Program, "_execute", _StandIn._execute)
    graphs.free_all()
    graphs.reset_builds()


def test_one_build_per_shape_and_its_data_each_call(monkeypatch):
    """The cache builds one program per shape: a second bucket of the same
    shape with other data reuses it (its buffers, its pieces) and gets its
    own result, equal to the plain executor's; another shape builds
    anew."""
    _standin_device(monkeypatch)
    CK.reset_launches()
    try:
        got = {}
        for seed in (41, 43):
            d = _bucket(seed)
            sg, dl, et, pr = _ascended(d)
            _, tkeys = _keys(3, base=seed)
            targs = (adopt_batch(_jbatch(d), torch.device("cpu")),
                     *map(_t, (sg, dl, et, pr)), np.array([5, 2, 3]), tkeys)
            got[seed] = TM.batched_perturbation_phase(*targs)
            monkeypatch.setattr(graphs, "ENABLED", False)
            want = TM.batched_perturbation_phase(*targs)
            monkeypatch.setattr(graphs, "ENABLED", True)
            _same(got[seed], want)
        assert len(graphs.BUILDS) == 1 and graphs.cached() == 1
        assert CK.GRAPHS["builds"] == 1 and CK.GRAPHS["launches"] == 2
        assert not all(torch.equal(a, b) for a, b in zip(got[41], got[43]))
        d = _bucket(47, B=2)
        sg, dl, et, pr = _ascended(d)
        TM.batched_perturbation_phase(
            adopt_batch(_jbatch(d), torch.device("cpu")),
            *map(_t, (sg, dl, et, pr)), np.array([2, 3]), _keys(2, 47)[1])
        assert len(graphs.BUILDS) == 2 and graphs.cached() == 2
    finally:
        graphs.free_all()
        graphs.reset_builds()
        CK.reset_launches()


def test_the_cache_is_empty_after_a_run(monkeypatch, tmp_path):
    """caller.run frees every program it built, as a new run would build
    anew."""
    from longcallr_tpu_torch.config import preset
    from longcallr_tpu_torch.pipeline.caller import run
    from longcallr_tpu_torch.utils.bench_workload import make_deep_workload

    bam, fa = str(tmp_path / "d.bam"), str(tmp_path / "d.fa")
    make_deep_workload(bam, fa, n_regions=2, region_len=2400,
                       snp_spacing=120, coverage=20, read_len=600,
                       err_rate=0.0, gap=3000, seed=7, contig="chrW")
    _standin_device(monkeypatch)
    try:
        run(bam, fa, str(tmp_path / "out"), preset("hifi-masseq"),
            device=torch.device("cpu"), batched=True)
        assert graphs.BUILDS and graphs.cached() == 0
    finally:
        graphs.free_all()
        graphs.reset_builds()


def _turns(n_max: int = 8):
    """A stand-in program over the input ``n``: its loop's body adds 1 to
    a counter until the counter reaches ``n``."""
    n = torch.zeros((), dtype=torch.int64)
    x = torch.zeros((), dtype=torch.int64)
    flag = torch.zeros((), dtype=torch.bool)

    def start():
        x.zero_()
        flag.copy_(x < n)

    def turn():
        x.add_(1)
        flag.copy_(x < n)

    return _StandIn(torch.device("cpu"), {"n": n}, (
        graphs.Piece("start", start),
        graphs.While(flag, (graphs.Piece("turn", turn),))), (x,))


def test_a_miscounted_condition_raises():
    """The device's count of set-condition launches must agree with its
    body-run counters: a program whose count disagrees raises."""
    prog = _turns()
    prog.load({"n": 3})
    prog.build()
    real = _StandIn._execute

    def off_by_one(self):
        outs, runs, sets = real(self)
        return outs, runs, sets + 1

    prog._execute = off_by_one.__get__(prog)
    with pytest.raises(RuntimeError, match="set-condition"):
        prog.launch()
    CK.reset_launches()


def test_threads_of_one_shape_share_its_program(monkeypatch):
    """Threads that run one shape at once (the rows of a mesh on one card,
    the per-region loop's workers) take turns on its one program: one
    build, and each call gets its own data's result."""
    import sys
    _standin_device(monkeypatch)
    CK.reset_launches()
    got, errors = {}, []

    def call(n):
        try:
            got[n] = int(graphs.run(("turns",), torch.device("cpu"), _turns,
                                    {"n": n})[0])
        except Exception as exc:            # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=call, args=(n,))
                   for n in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not errors and got == {n: n for n in range(12)}
        assert len(graphs.BUILDS) == 1 and graphs.cached() == 1
        assert CK.GRAPHS["launches"] == 12
        assert CK.GRAPHS["body_runs"] == sum(range(12))
        assert graphs.free_all() == 1 and graphs.cached() == 0
    finally:
        sys.setswitchinterval(interval)
        graphs.free_all()
        graphs.reset_builds()
        CK.reset_launches()


def test_programs_beyond_the_budget_are_freed_oldest_first(monkeypatch):
    """The programs of a card hold at most the bucket budget: past it, the
    program used least recently is freed, and its shape builds anew at its
    next call, with the same result."""
    _standin_device(monkeypatch)
    allocated = {"bytes": 0}
    build = _StandIn.build

    def build_100(self):
        allocated["bytes"] += 100
        return build(self)

    monkeypatch.setattr(_StandIn, "build", build_100)
    monkeypatch.setattr(graphs, "_allocated", lambda d: allocated["bytes"])
    monkeypatch.setattr(graphs, "_budget", lambda: 250)
    cpu = torch.device("cpu")
    CK.reset_launches()
    try:
        for kind in ("a", "b", "a", "c"):
            assert int(graphs.run((kind,), cpu, _turns, {"n": 3})[0]) == 3
        # a was used after b: b goes when c makes 300 bytes
        assert CK.GRAPHS["evicted"] == 1 and graphs.cached() == 2
        assert sorted(k[0] for k in graphs._CACHE) == ["a", "c"]
        assert [eval(b["key"])[0] for b in graphs.BUILDS] == ["a", "b", "c"]
        assert int(graphs.run(("b",), cpu, _turns, {"n": 5})[0]) == 5
        assert [eval(b["key"])[0] for b in graphs.BUILDS] == \
            ["a", "b", "c", "b"]
        assert CK.GRAPHS["evicted"] == 2 and graphs.cached() == 2
    finally:
        graphs.free_all()
        graphs.reset_builds()
        CK.reset_launches()


def test_a_capture_counts_nothing():
    CK.reset_launches()
    with CK.recording() as launches:
        _launch_each()
    assert CK.LAUNCHES == {"dual_matvec_rows": 0, "matvec_cols": 0}
    assert [n for n, _, _ in launches] == ["dual_matvec_rows", "matvec_cols"]
    _launch_each()
    assert CK.LAUNCHES == {"dual_matvec_rows": 1, "matvec_cols": 1}
    CK.reset_launches()


def test_a_graph_keeps_its_workspace_when_the_stream_grows_one():
    """The cols workspace of a capture's stream goes to the graph: a later
    call on that stream that needs more scratch makes a new one and cannot
    free the memory the graph writes at every replay."""
    dev, stream = torch.device("cpu"), 0x5EED
    try:
        ws = CK._workspace(dev, stream, 64, 8)
        kept = CK.take_workspaces(dev, stream)
        assert kept is ws and (dev.index, stream) not in CK._WORKSPACES
        grown = CK._workspace(dev, stream, 4096, 8)
        assert grown[0] is not kept[0] and kept[0].numel() >= 64
        assert CK.take_workspaces(dev, stream) is grown
        assert CK.take_workspaces(dev, stream) == []
    finally:
        CK._WORKSPACES.pop((dev.index, stream), None)
