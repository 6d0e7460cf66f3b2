"""The ascent program (``optimize._ascent``) against the JAX package's
compiled ascents, on the CPU.

Every ascent of the port is one ``graphs.Program``: a piece that builds the
tables from the cells and the entry σ and runs the first chunk of trips, a
``While`` loop of chunks, a piece that scores the final state. The card
runs it as one device program; the CPU walks the same description with the
plain executor, which is what runs here. The same seeded numpy inputs go
through the JAX package's functions (CPU backend, f64) and the port's:
``cross_optimize`` for the four (with_genotype, keep_conserved) cases,
``batched_cross_optimize``, ``batched_enum_cross_optimize`` at (B, C) =
(3, 16) and (2, 64), ``phase_region`` on an enumeration and an iterative
region, and the staged chain of ``phase_regions_batched`` (the CPU's own
path). Sizes: K <= 256, I <= 16, C <= 64, B <= 4.

Tolerances: σ, δ, η and trip counts equal; objectives to 1e-12 relative
(summation order only). A dispatch-mode guard fails on any host sync
inside a piece of the program (what a capture would refuse); a stand-in
device that "builds" on the CPU shows one build per shape however many
chunks call it; and the plain executor's host reads of the continue flag
are counted, as are those of the reads-sharded ascent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcallr_tpu.parallel import mesh as JM
from longcallr_tpu.phasing import batch_driver as JBD
from longcallr_tpu.phasing import kernels as JK
from longcallr_tpu.phasing import optimize as JO
from longcallr_tpu_torch.parallel import mesh as TM
from longcallr_tpu_torch.phasing import batch_driver as TBD
from longcallr_tpu_torch.phasing import cuda_kernels as CK
from longcallr_tpu_torch.phasing import graphs
from longcallr_tpu_torch.phasing import kernels as TK
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.utils.adopt import adopt_batch
from tests.test_torch_graphs import (SyncGuard, _counting_program,
                                     _standin_device)

CPU = torch.device("cpu")
RTOL = 1e-12
CASES = [(False, False), (False, True), (True, False), (True, True)]


def _t(a):
    return torch.as_tensor(np.array(a))


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _cells(r, shape, noise=0.05):
    """Planted cells: reads on one of two haplotypes, 5 % noise, 60 % of
    the cells present; baseq 3..30."""
    *lead, K, I = shape
    hap = r.choice([-1, 1], size=(*lead, K, 1))
    td = r.choice([-1, 1], size=(*lead, 1, I))
    p = hap * td
    p = np.where(r.random(shape) < noise, -p, p)
    p = np.where(r.random(shape) < 0.6, p, 0).astype(np.int8)
    return p, r.integers(3, 31, size=shape).astype(np.uint8)


def _bucket(seed, B, K, I):
    r = np.random.default_rng(seed)
    p, q = _cells(r, (B, K, I))
    rb = r.random((B, K)) < 0.9
    return dict(p=p, q=q, rb=rb, sm=r.random((B, I)) < 0.95,
                cons=r.random((B, I)) < 0.2,
                sg0=np.where(rb, r.choice([-1.0, 1.0], size=(B, K)), 0.0),
                dl0=r.choice([-1.0, 1.0], size=(B, I)),
                et0=r.choice([-1.0, 0.0, 0.0, 1.0], size=(B, I)))


def _jbatch(d):
    return JM.BatchedRegions(
        p=jnp.asarray(d["p"]), q=jnp.asarray(d["q"]),
        read_base=jnp.asarray(d["rb"]), site_mask=jnp.asarray(d["sm"]),
        conserved=jnp.asarray(d["cons"]))


_jax_ascent = jax.jit(JO._cross_optimize_fast_loop_it,
                      static_argnames=("with_genotype", "keep_conserved"))


def _jax_trips(ct, sg, dl, et, rb, sm, cons, with_genotype, keep_conserved):
    """Each member's trips in the JAX package's while_loop (vmapped over
    the leading axis of the state)."""
    one = lambda s, d, e: _jax_ascent(
        ct, JO.PhaseState(s, d, e), rb, sm, cons,
        with_genotype=with_genotype, keep_conserved=keep_conserved)[2]
    return np.asarray(jax.vmap(one)(jnp.asarray(sg), jnp.asarray(dl),
                                    jnp.asarray(et)))


# --- one region, the four cases ---------------------------------------------------

@pytest.mark.parametrize("with_genotype,keep_conserved", CASES)
def test_cross_optimize_matches_jax(with_genotype, keep_conserved):
    """One region (K 96, I 16): state and trips equal the JAX package's
    while_loop, objective to 1e-12; cross_optimize gives the same state
    and objective."""
    d = {k: v[0] for k, v in _bucket(11, 1, 96, 16).items()}
    jct = JK.make_cell_tables(d["p"], d["q"])
    jst, jprob, jtrips = _jax_ascent(
        jct, JO.PhaseState(*(jnp.asarray(d[k]) for k in ("sg0", "dl0",
                                                            "et0"))),
        jnp.asarray(d["rb"]), jnp.asarray(d["sm"]), jnp.asarray(d["cons"]),
        with_genotype=with_genotype, keep_conserved=keep_conserved)
    cc = TK.CompactCells.from_numpy(d["p"], d["q"])
    st0 = TO.PhaseState(*(_t(d[k]) for k in ("sg0", "dl0", "et0")))
    args = (_t(d["rb"]), _t(d["sm"]), _t(d["cons"]), with_genotype,
            keep_conserved)
    got, prob, trips = TO._cross_optimize_fast_loop_it(cc, st0, *args, False)
    _same(got, jst)
    assert int(trips) == int(jtrips) >= 1
    np.testing.assert_allclose(float(prob), float(jprob), rtol=RTOL)
    st, pr = TO.cross_optimize(cc, st0, *args)
    _same(st, got)
    assert torch.equal(pr, prob)
    assert torch.equal(st0.sigma, _t(d["sg0"]))      # the input stays


def test_batched_cross_optimize_matches_jax():
    """A bucket of 4 (K 128, I 16): states equal the JAX package's vmapped
    ascent, objectives to 1e-12, and the port's trips are the most any
    member took in its own while_loop."""
    d = _bucket(12, 4, 128, 16)
    args = [d[k] for k in ("sg0", "dl0", "et0")]
    want = JM.batched_cross_optimize(_jbatch(d), *map(jnp.asarray, args))
    tb = adopt_batch(_jbatch(d), CPU)
    got = TM.batched_cross_optimize(tb, *map(_t, args))
    _same(got[:3], want[:3])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=RTOL)
    _, _, trips = TO._cross_optimize_fast_loop_it(
        tb.cells, TO.PhaseState(*map(_t, args)), tb.read_base, tb.site_mask,
        tb.conserved, False, True, False)
    each = [_jax_trips(JK.make_cell_tables(d["p"][b], d["q"][b]),
                       *(a[b][None] for a in args), jnp.asarray(d["rb"][b]),
                       jnp.asarray(d["sm"][b]), jnp.asarray(d["cons"][b]),
                       False, True)[0] for b in range(4)]
    assert int(trips) == max(each)


# --- the enumeration ascent ---------------------------------------------------------

def _enum(seed, B, C, K=64, I=8):
    from longcallr_tpu_torch.phasing.optimize import enumeration_order

    d = _bucket(seed, B, K, I)
    I0 = C.bit_length() - 1
    d["sm"][:, I0:] = False
    r = np.random.default_rng(seed + 1)
    configs = np.pad(enumeration_order(I0).astype(np.float64),
                     ((0, 0), (0, I - I0)), constant_values=1.0)
    sig0 = np.where(d["rb"][:, None, :],
                    r.choice([-1.0, 1.0], size=(B, C, K)), 0.0)
    eta0 = r.choice([-1.0, 0.0, 1.0], size=(B, I))
    return d, configs, sig0, eta0


@pytest.mark.parametrize("B,C", [(3, 16), (2, 64)])
def test_batched_enum_cross_optimize_matches_jax(B, C):
    """Regions x configs through one ascent program: states equal the JAX
    package's, objectives to 1e-12; trips are the most any config of any
    region took in its own while_loop."""
    d, configs, sig0, eta0 = _enum(13 + C, B, C)
    want = JM.batched_enum_cross_optimize(
        _jbatch(d), jnp.asarray(sig0), jnp.asarray(configs),
        jnp.asarray(eta0))
    tb = adopt_batch(_jbatch(d), CPU)
    got = TM.batched_enum_cross_optimize(tb, _t(sig0), _t(configs), _t(eta0))
    assert got[0].shape == (B, C, 64) and got[3].shape == (B, C)
    _same(got[:3], want[:3])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=RTOL)
    I = configs.shape[1]
    st0 = TO.PhaseState(_t(sig0), _t(configs).expand(B, C, I),
                        _t(eta0)[:, None].expand(B, C, I))
    _, _, trips = TO._ascent(tb.cells, st0, tb.read_base, tb.site_mask,
                             torch.zeros_like(tb.site_mask), True, False,
                             False, fast=True)
    each = [_jax_trips(JK.make_cell_tables(d["p"][b], d["q"][b]), sig0[b],
                       configs, np.broadcast_to(eta0[b], (C, I)),
                       jnp.asarray(d["rb"][b]), jnp.asarray(d["sm"][b]),
                       jnp.zeros(I, bool), True, False).max()
            for b in range(B)]
    assert int(trips) == max(each)


def test_members_with_other_read_sets_are_refused():
    """Configs of a region must share its active-read set: checked on the
    host before the program runs."""
    d, configs, sig0, eta0 = _enum(17, 2, 16)
    sig0[1, 3, int(np.flatnonzero(d["rb"][1])[0])] = 0.0
    with pytest.raises(ValueError, match="active-read set"):
        TM.batched_enum_cross_optimize(adopt_batch(_jbatch(d), CPU),
                                       _t(sig0), _t(configs), _t(eta0))


# --- the paths that run it --------------------------------------------------------------

# (seed, planted hets, reads): a bucket of two iterative regions and one
# of two enumeration regions
SPECS = [(71, 12, 30), (72, 12, 25), (73, 4, 30), (74, 4, 25)]


@pytest.fixture(scope="module")
def regions(tmp_path_factory):
    """{package: (cfg, [(frags, cands, seed, False)])} of the SPECS regions,
    simulated once and taken through each package's own candidate and
    fragment stages."""
    from tests.test_torch_batched import _sim_region

    tmp = tmp_path_factory.mktemp("regions")
    out = {}
    for pkg in ("jax", "torch"):
        items = []
        for seed, n_het, n_reads in SPECS:
            cfg, cands, frags = _sim_region(tmp, seed, n_het, n_reads, pkg)
            items.append((frags, cands, 100 + seed, False))
        out[pkg] = (cfg, items)
    return out


@pytest.mark.parametrize("index,path", [(2, "enumeration"),
                                        (0, "iterative")])
def test_phase_region_matches_jax(regions, index, path, monkeypatch):
    """phase_region on the CPU (f64) vs the JAX package: equal states; the
    region's ascents went through the ascent program."""
    kinds = []
    run = graphs.run

    def spy(kind, device, make, values, capture=True):
        kinds.append(kind[0])
        return run(kind, device, make, values, capture)

    monkeypatch.setattr(graphs, "run", spy)
    jcfg, jitems = regions["jax"]
    cfg, titems = regions["torch"]
    jf, jc, seed, _ = jitems[index]
    tf, tc, _, _ = titems[index]
    assert (tc.n <= cfg.max_enum_snps) == (path == "enumeration")
    want = JO.phase_region(jf, jc, jcfg, seed=seed)
    got = TO.phase_region(tf, tc, cfg, seed=seed, device=CPU)
    _same(got, want)
    assert kinds[0] == "ascent"
    assert kinds.count("schedule") == (path == "iterative")


def test_staged_chain_of_phase_regions_batched_matches_jax(regions,
                                                           monkeypatch):
    """The CPU's batched path is the staged chain: its first ascent, the
    enumeration bucket's ascent and the single region's through the ascent
    program; every region's state equals the JAX package's."""
    kinds = []
    run = graphs.run

    def spy(kind, device, make, values, capture=True):
        kinds.append(kind[0])
        return run(kind, device, make, values, capture)

    monkeypatch.setattr(graphs, "run", spy)
    jcfg, jitems = regions["jax"]
    cfg, titems = regions["torch"]
    got = TBD.phase_regions_batched(titems, cfg, device=CPU)
    want = JBD.phase_regions_batched(jitems, jcfg)
    for g, w in zip(got, want):
        _same(g, w)
    assert "fused" not in kinds and kinds.count("bucket_schedule") >= 1
    assert kinds.count("ascent") >= 2


# --- the program itself ---------------------------------------------------------------

def test_no_piece_of_the_ascent_program_syncs(monkeypatch):
    """Every piece of the ascent program runs under a guard that fails on
    a host sync: one region, a bucket and a bucket's configs in split mode
    (the card's), and a bucket in f64."""
    names = []

    def call(self, piece):
        names.append(piece.name)
        with SyncGuard():
            piece.fn()

    monkeypatch.setattr(graphs.Program, "_call", call)
    d = _bucket(21, 2, 32, 8)
    tb = adopt_batch(_jbatch(d), CPU)
    st = TO.PhaseState(*(_t(d[k]) for k in ("sg0", "dl0", "et0")))
    e, configs, sig0, eta0 = _enum(22, 2, 16, K=32)
    eb = adopt_batch(_jbatch(e), CPU)
    TM.batched_cross_optimize(tb, *st, split=False)
    TM.batched_cross_optimize(tb, *st, split=True)
    TO.cross_optimize(TK.CompactCells(tb.p[0], tb.q[0]),
                      TO.PhaseState(*(a[0] for a in st)), tb.read_base[0],
                      tb.site_mask[0], tb.conserved[0], False, True,
                      split=True)
    TM.batched_enum_cross_optimize(eb, _t(sig0), _t(configs), _t(eta0),
                                   split=True)
    assert names.count("start") == names.count("objective") == 4
    assert "ascent" in names


def test_one_build_per_shape_however_many_chunks(monkeypatch):
    """On a stand-in device the enumeration chunks of one shape build one
    program; each call gets its own data's result, equal to the plain
    executor's; another shape builds anew."""
    _standin_device(monkeypatch)
    CK.reset_launches()
    try:
        d, configs, sig0, eta0 = _enum(31, 2, 64)
        tb = adopt_batch(_jbatch(d), CPU)
        for c in range(0, 64, 16):
            args = (tb, _t(sig0[:, c:c + 16]), _t(configs[c:c + 16]),
                    _t(eta0))
            got = TM.batched_enum_cross_optimize(*args)
            monkeypatch.setattr(graphs, "ENABLED", False)
            want = TM.batched_enum_cross_optimize(*args)
            monkeypatch.setattr(graphs, "ENABLED", True)
            _same(got, want)
        assert len(graphs.BUILDS) == 1 and graphs.cached() == 1
        assert CK.GRAPHS["builds"] == 1 and CK.GRAPHS["launches"] == 4
        TM.batched_enum_cross_optimize(tb, _t(sig0[:, :32]),
                                       _t(configs[:32]), _t(eta0))
        assert len(graphs.BUILDS) == 2 and graphs.cached() == 2
    finally:
        graphs.free_all()
        graphs.reset_builds()
        CK.reset_launches()


@pytest.mark.parametrize("fast", [True, False], ids=["matvec", "spec"])
def test_the_plain_executors_flag_reads_are_counted(fast, monkeypatch):
    """An ascent on the plain executor (the CPU, the reference form, or the
    card with programs off) reads its continue flag on the host once after
    the first chunk and once after each further one: every read is
    counted in cuda_kernels.GRAPHS["flag_reads"]."""
    chunks = []
    call = graphs.Program._call

    def counting(self, piece):
        chunks.append(piece.name)
        call(self, piece)

    monkeypatch.setattr(graphs.Program, "_call", counting)
    monkeypatch.setattr(TO, "ASCENT_CHUNK", 1)
    d = _bucket(41, 3, 64, 16)
    tb = adopt_batch(_jbatch(d), CPU)
    st = TO.PhaseState(*(_t(d[k]) for k in ("sg0", "dl0", "et0")))
    CK.reset_launches()
    try:
        _, _, trips = TO._ascent(tb.cells, st, tb.read_base, tb.site_mask,
                                 tb.conserved, False, True, False, fast)
        assert CK.GRAPHS["flag_reads"] == 1 + chunks.count("ascent") >= 2
        # chunks of one trip: the last read finds no member ascending
        assert chunks.count("ascent") in (int(trips), int(trips) - 1)
        assert CK.GRAPHS["launches"] == 0
    finally:
        CK.reset_launches()


def test_the_sharded_ascents_flag_reads_are_counted():
    """The reads-sharded ascent of a giant region (two CPU shards) reads
    its continue flag on the host once a trip: counted too. It takes the
    trips and reaches the state of the ascent program."""
    d = {k: v[0] for k, v in _bucket(51, 1, 96, 16).items()}
    CK.reset_launches()
    try:
        out = TM.sharded_cross_optimize([CPU, CPU])(
            d["p"], d["q"], d["sg0"], d["dl0"], d["et0"], d["rb"], d["sm"],
            d["cons"])
        reads = CK.GRAPHS["flag_reads"]
    finally:
        CK.reset_launches()
    st, _, trips = TO._cross_optimize_fast_loop_it(
        TK.CompactCells.from_numpy(d["p"], d["q"]),
        TO.PhaseState(*(_t(d[k]) for k in ("sg0", "dl0", "et0"))),
        _t(d["rb"]), _t(d["sm"]), _t(d["cons"]), False, False, False)
    _same(out[:3], st)
    assert reads == int(trips) >= 2


def test_launches_are_counted_by_shape():
    """cuda_kernels.LAUNCHES_BY_SHAPE counts each wrapper's launches at each
    (tables, K, I, members) shape, those a program's runs add included, and
    reset_launches clears it."""
    CK.reset_launches()
    try:
        prog = _counting_program(4)
        prog.build()
        prog.launch()
        assert CK.LAUNCHES_BY_SHAPE == {
            ("dual_matvec_rows", (2, 8, 4, 1)): 5,
            ("matvec_cols", (2, 8, 4, 1)): 5}
        assert sum(CK.LAUNCHES_BY_SHAPE.values()) == \
            sum(CK.LAUNCHES.values())
    finally:
        CK.reset_launches()
    assert CK.LAUNCHES_BY_SHAPE == {}
