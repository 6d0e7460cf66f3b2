"""The perturbation schedule as capturable steps (phasing/graphs.py) against
the JAX package's compiled programs, on the CPU.

The port runs an ascent in chunks of ``optimize.ASCENT_CHUNK`` masked trips
with one read of the continue flag per chunk, and the schedule as four
steps over tensors updated in place (``optimize._run_schedule``), which a
``graphs.Runner`` captures as CUDA graphs on the card and calls as they are
on the CPU. Here the CPU form goes through the same seeded numpy inputs as
the JAX package's ``jax.jit`` programs (``while_loop`` ascents,
``fori_loop`` schedules, CPU backend, f64): states and trip counts equal,
objectives to 1e-12 relative (summation order only), for chunks of 1 (every
ascent overruns its chunk and takes the "more" step), 2 (the default) and
21 (one chunk holds every trip). A dispatch-mode guard fails on any host
sync inside a step: what the card could not capture.
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
    """Every step a Runner calls runs under SyncGuard; the flag reads
    between steps (the host's) do not."""
    steps = []
    call = graphs.Runner.__call__

    def run(self, name, step):
        def under_guard():
            with SyncGuard():
                step()
        steps.append(name)
        return call(self, name, under_guard)

    monkeypatch.setattr(graphs.Runner, "__call__", run)
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


def test_trip_cap_and_frozen_members(chunk):
    """Stand-in half-steps: member 0 never converges and stops at the 21-trip
    cap, member 1 converges after its third trip and keeps that state."""
    sigma0 = torch.ones(2, 4, dtype=torch.float64)
    st0 = TO.PhaseState(sigma0, torch.zeros(2, 3, dtype=torch.float64),
                        torch.zeros(2, 3, dtype=torch.float64))

    def sigma_step(st):
        return -st.sigma, torch.tensor([True, False])

    def snp_step(st):
        return st.delta + 1.0, st.eta, st.delta[:, 0] < 2.0

    got, trips = TO._ascend(st0, sigma_step, snp_step)
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
    the reference form, and its runner never captures."""
    made = []
    init = graphs.Runner.__init__

    def spy(self, device, capture=True):
        init(self, device, capture)
        made.append(capture)

    monkeypatch.setattr(graphs.Runner, "__init__", spy)
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


# --- the runner ------------------------------------------------------------------

def test_runner_on_the_cpu_calls_each_step():
    run = graphs.Runner(torch.device("cpu"))
    assert not run.graphs
    seen = []
    for _ in range(3):
        run("step", lambda: seen.append(1))
    assert seen == [1, 1, 1]
    assert run.flag(torch.tensor(True)) is True
    assert run.flag(torch.tensor(False)) is False


class _StandIn(graphs.Runner):
    """A runner that 'captures' on the CPU: the capture records the
    wrappers' launches as on the card, and a replay runs nothing."""

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.graphs = True

    def _capture(self, name, step):
        with CK.recording() as launches:
            step()
        self._captured[name] = (SimpleNamespace(replay=lambda: None),
                                launches, [])
        CK.count_capture(0.0)


def _launch_each():
    """What a step that calls each wrapper once counts on the card."""
    hi = torch.zeros(2, 8, 4, dtype=torch.float32)
    CK._count("dual_matvec_rows", hi, 1, 0)
    CK._count("matvec_cols", hi, 1, 0)


@pytest.mark.parametrize("n", [1, 5])
def test_replays_add_the_captured_launches_for_the_row(n):
    CK.reset_launches()
    run = _StandIn()
    out = {}

    def row():
        CK.set_launch_row(3)
        try:
            run("step", _launch_each)          # eager first call, capture
            out["first"] = dict(CK.LAUNCHES)
            for _ in range(n):
                run("step", _launch_each)      # replays
        finally:
            CK.set_launch_row(None)

    th = threading.Thread(target=row)
    th.start()
    th.join()
    try:
        assert out["first"] == {"dual_matvec_rows": 1, "matvec_cols": 1}
        assert CK.LAUNCHES == {"dual_matvec_rows": n + 1,
                               "matvec_cols": n + 1}
        assert CK.LAUNCHES_BY_ROW == {3: dict(CK.LAUNCHES)}
        assert CK.LAUNCHES_BY_DEVICE == {0: dict(CK.LAUNCHES)}
        assert CK.LAUNCH_SHAPES["matvec_cols"] == {(2, 8, 4, 1)}
        assert CK.GRAPHS["replays"] == n and CK.GRAPHS["captures"] == 1
        assert CK.GRAPH_LAUNCHES == {"dual_matvec_rows": n,
                                     "matvec_cols": n}
    finally:
        CK.reset_launches()
    assert CK.GRAPHS == {"replays": 0, "captures": 0, "capture_seconds": 0.0}
    assert CK.GRAPH_LAUNCHES == {"dual_matvec_rows": 0, "matvec_cols": 0}


def test_replays_from_many_threads_lose_no_count():
    """Rows of a mesh replay in threads of their own: 16 threads, each its
    own stand-in runner and row, with a short switch interval; no replay
    and no launch is lost."""
    import sys
    CK.reset_launches()
    n_threads, n = 16, 200
    errors = []

    def row(r):
        try:
            CK.set_launch_row(r)
            run = _StandIn()
            for _ in range(n + 1):
                run("step", _launch_each)
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
        assert CK.GRAPHS["replays"] == n_threads * n
        assert CK.GRAPHS["captures"] == n_threads
        assert CK.GRAPH_LAUNCHES == {k: n_threads * n for k in each}
    finally:
        sys.setswitchinterval(interval)
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
