"""The torch port's bucket programs and bucket phasing vs the JAX package.

The same seeded numpy arrays (a bucket of B regions: cells, masks, states,
round counts, per-region keys) go through each ``batched_*`` program of
``longcallr_tpu.parallel.mesh`` (CPU backend) and its counterpart in
``longcallr_tpu_torch.parallel.mesh`` (CPU tensors, so the hand kernels'
plain versions run). Sizes: B <= 4, K <= 256, I <= 64.

Tolerances. f64 mode: σ, δ, η and masks equal, objectives to 1e-12
relative (summation order only). Split mode (both packages forced into
it): states equal, sums within 1e-4 absolute — the JAX package accumulates
f32 chunk partials, the port widens every cell to f64, and 1e-4 is the
JAX package's own bound for the split sums. Port against port (fused vs
staged, batched vs per region, alone vs with bucket-mates): bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcallr_tpu.config import preset as jax_preset
from longcallr_tpu.io.bam import BamFile as JaxBamFile
from longcallr_tpu.ops import candidates as JC
from longcallr_tpu.parallel import mesh as JM
from longcallr_tpu.phasing import batch_driver as JBD
from longcallr_tpu.phasing import optimize as JO
from longcallr_tpu.phasing.fragments import get_fragments as jax_get_fragments
from longcallr_tpu.tiles.pileup import build_pileup as jax_build_pileup
from longcallr_tpu.tiles.regions import Region as JaxRegion
from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.ops import candidates as TC
from longcallr_tpu_torch.parallel import giant
from longcallr_tpu_torch.parallel import mesh as TM
from longcallr_tpu_torch.phasing import batch_driver as TBD
from longcallr_tpu_torch.phasing import kernels_fast as TKF
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.phasing import rng as TR
from longcallr_tpu_torch.phasing.fragments import get_fragments
from longcallr_tpu_torch.phasing.kernels import CompactCells, expand_cells
from longcallr_tpu_torch.pipeline.engine import STAGE_TOTALS
from longcallr_tpu_torch.tiles.pileup import build_pileup
from longcallr_tpu_torch.tiles.regions import Region
from longcallr_tpu_torch.utils.adopt import adopt, adopt_batch, adopt_state
from longcallr_tpu_torch.utils.simulate import (make_reference, plant_snps,
                                                simulate_bam)

CPU = torch.device("cpu")
MODES = ["f64", "split"]
RTOL = 1e-12          # f64 objectives: summation order only
SPLIT_ATOL = 1e-4     # split sums: the JAX package's own bound


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture
def mode(request, monkeypatch):
    """Both packages in f64 mode or both forced into split mode; the JAX
    jit caches are cleared around a forced mode (the mode is resolved at
    trace time)."""
    forced = True if request.param == "split" else False
    monkeypatch.setattr(JO, "USE_F32_KERNELS", forced)
    monkeypatch.setattr(TO, "USE_F32_KERNELS", forced)
    jax.clear_caches()
    yield request.param
    jax.clear_caches()


def _bucket(seed, B=3, K=64, I=16, noise=0.05):
    """A planted bucket: reads carry one of two haplotypes with 5 % cell
    noise, so ascents, flips and perturbations do real work and decisions
    are not near-ties."""
    r = np.random.default_rng(seed)
    hap = r.choice([-1, 1], size=(B, K))
    td = r.choice([-1.0, 1.0], size=(B, I))
    exists = r.random((B, K, I)) < 0.6
    p = (hap[:, :, None] * td[:, None, :]).astype(np.int8)
    p = np.where(r.random((B, K, I)) < noise, -p, p)
    p = np.where(exists, p, 0).astype(np.int8)
    q = r.integers(3, 31, size=(B, K, I)).astype(np.uint8)
    rb = r.random((B, K)) < 0.95
    sm = r.random((B, I)) < 0.95
    cons = r.random((B, I)) < 0.15
    sg0 = np.where(rb, r.choice([-1.0, 1.0], size=(B, K)), 0.0)
    dl0 = r.choice([-1.0, 1.0], size=(B, I))
    et0 = np.zeros((B, I))
    bid = np.full((B, I), -1, np.int32)
    bid[:, 0:3] = 0
    bid[:, 4:6] = 1
    bid[:, 9:12] = 2
    return dict(p=p, q=q, rb=rb, sm=sm, cons=cons, sg0=sg0, dl0=dl0, et0=et0,
                bid=bid, B=B, K=K, I=I)


def _jbatch(d):
    return JM.BatchedRegions(
        p=jnp.asarray(d["p"]), q=jnp.asarray(d["q"]),
        read_base=jnp.asarray(d["rb"]), site_mask=jnp.asarray(d["sm"]),
        conserved=jnp.asarray(d["cons"]))


def _tbatch(d):
    return adopt_batch(_jbatch(d), CPU)


def _keys(B, base=7):
    seeds = [base + 1000003 * b for b in range(B)]
    return (jnp.stack([jax.random.PRNGKey(s) for s in seeds]),
            [TR.prng_key(s) for s in seeds])


def _same_states(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _same_probs(got, want, mode):
    got, want = got.numpy(), np.asarray(want)
    if mode == "f64":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=SPLIT_ATOL)


# --- the carriers ---------------------------------------------------------

def test_adopt_batch_and_state_carry_a_bucket():
    d = _bucket(1)
    tb = _tbatch(d)
    assert isinstance(tb, TM.BatchedRegions)
    assert tb.p.dtype == torch.int8 and tb.q.dtype == torch.uint8
    assert tb.read_base.dtype == torch.bool and tb.p.shape == (3, 64, 16)
    for f, k in zip(tb, ("p", "q", "rb", "sm", "cons")):
        np.testing.assert_array_equal(f.numpy(), d[k])
    st = adopt_state(JO.PhaseState(jnp.asarray(d["sg0"]),
                                   jnp.asarray(d["dl0"]),
                                   jnp.asarray(d["et0"])), CPU)
    assert isinstance(st, TO.PhaseState) and st.sigma.dtype == torch.float64
    np.testing.assert_array_equal(st.sigma.numpy(), d["sg0"])
    np.testing.assert_array_equal(st.delta.numpy(), d["dl0"])


# --- tables with a region axis --------------------------------------------

@pytest.mark.parametrize("build", ["f64", "split", "split_from_compact"])
def test_bucket_tables_equal_each_members_own(build):
    """Tables built for a whole bucket hold, per member, the values of the
    unbatched build bit for bit (same chunks, same combine order)."""
    d = _bucket(2, B=4, K=128, I=32)
    cc = CompactCells.from_numpy(d["p"], d["q"])
    rm, sm = _t(d["rb"]), _t(d["sm"])

    def make(cells, rm1, sm1):
        if build == "f64":
            return TKF.make_fast_tables(expand_cells(cells), rm1, sm1)
        if build == "split":
            return TKF.make_fast_tables32(expand_cells(cells), rm1, sm1)
        return TKF.fast_tables32_from_compact(cells, rm1, sm1)

    ft = make(cc, rm, sm)
    for b in range(4):
        one = make(CompactCells(cc.p[b], cc.q[b]), rm[b], sm[b])
        for name, a, w in zip(ft._fields, ft, one):
            a = a[:, b] if name == "dp2" else a[b]
            assert torch.equal(a, w), (name, b)


def test_for_members_gives_the_configs_axis():
    d = _bucket(3, B=2, K=32, I=8)
    cc = CompactCells.from_numpy(d["p"], d["q"])
    for ft in (TKF.fast_tables32_from_compact(cc, _t(d["rb"]), _t(d["sm"])),
               TKF.make_fast_tables(expand_cells(cc), _t(d["rb"]),
                                    _t(d["sm"]))):
        fm = TKF.for_members(ft)
        assert type(fm) is type(ft)
        assert fm.row_b.shape == (2, 1, 32) and fm.cov.shape == (2, 1, 8)
        assert fm.read_mask.shape == (2, 1, 32)
        if isinstance(ft, TKF.FastTables32):
            assert fm.dp2 is ft.dp2
        else:
            assert fm.dp.shape == (2, 1, 32, 8)


def test_fast_tables_for_refuses_members_with_other_read_sets():
    d = _bucket(4, B=2, K=32, I=8)
    cc = CompactCells.from_numpy(d["p"], d["q"])
    sg = np.where(d["rb"][:, None, :], 1.0, 0.0).repeat(3, axis=1)
    ok = TO._fast_tables_for(cc, _t(d["rb"])[:, None], _t(sg), _t(d["sm"]),
                             True)
    assert ok.read_mask.shape == (2, 32)
    sg[1, 2, int(np.flatnonzero(d["rb"][1])[0])] = 0.0
    with pytest.raises(ValueError, match="active-read set"):
        TO._fast_tables_for(cc, _t(d["rb"])[:, None], _t(sg), _t(d["sm"]),
                            True)


# --- each program against its JAX counterpart ------------------------------

@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("keep_conserved,with_genotype",
                         [(True, False), (False, True)])
def test_batched_cross_optimize_matches_jax(mode, keep_conserved,
                                            with_genotype):
    d = _bucket(11)
    want = JM.batched_cross_optimize(
        _jbatch(d), jnp.asarray(d["sg0"]), jnp.asarray(d["dl0"]),
        jnp.asarray(d["et0"]), keep_conserved=keep_conserved,
        with_genotype=with_genotype)
    got = TM.batched_cross_optimize(
        _tbatch(d), _t(d["sg0"]), _t(d["dl0"]), _t(d["et0"]),
        keep_conserved=keep_conserved, with_genotype=with_genotype)
    _same_states(got[:3], want[:3])
    _same_probs(got[3], want[3], mode)


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_batched_cross_optimize_spec_loop_matches_jax(mode, monkeypatch):
    """LONGCALLR_FAST_KERNELS=0: the reference-form ascent over a bucket."""
    monkeypatch.setattr(JO, "USE_FAST_KERNELS", False)
    monkeypatch.setattr(TO, "USE_FAST_KERNELS", False)
    d = _bucket(12, B=2, K=32, I=8)
    args = (d["sg0"], d["dl0"], d["et0"])
    want = JM.batched_cross_optimize(_jbatch(d), *map(jnp.asarray, args))
    got = TM.batched_cross_optimize(_tbatch(d), *map(_t, args))
    _same_states(got[:3], want[:3])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=RTOL)


def _ascended(d):
    """A first ascent in the JAX package: the state a schedule starts from
    (numpy)."""
    sg, dl, et, pr = JM.batched_cross_optimize(
        _jbatch(d), jnp.asarray(d["sg0"]), jnp.asarray(d["dl0"]),
        jnp.asarray(d["et0"]))
    return tuple(np.asarray(a) for a in (sg, dl, et, pr))


@pytest.mark.parametrize("mode", MODES, indirect=True)
@pytest.mark.parametrize("rounds", ["equal", "mixed"])
def test_batched_perturbation_phase_matches_jax(mode, rounds):
    """The schedule with per-region keys and per-region round counts: a
    member past its own count keeps its state while the others go on."""
    d = _bucket(13)
    B, I = d["B"], d["I"]
    sg, dl, et, pr = _ascended(d)
    n_rounds = (np.full(B, I // 4 + 1) if rounds == "equal"
                else np.array([I // 4 + 1, 1, 3]))
    jkeys, tkeys = _keys(B)
    want = JM.batched_perturbation_phase(
        _jbatch(d), jnp.asarray(sg), jnp.asarray(dl), jnp.asarray(et),
        jnp.asarray(pr), jnp.asarray(n_rounds.astype(np.int32)), jkeys)
    got = TM.batched_perturbation_phase(
        _tbatch(d), _t(sg), _t(dl), _t(et), _t(pr), n_rounds, tkeys)
    _same_states(got[:3], want[:3])
    _same_probs(got[3], want[3], mode)


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_batched_perturbation_phase_stats_matches_jax(mode):
    d = _bucket(14)
    B, I = d["B"], d["I"]
    sg, dl, et, pr = _ascended(d)
    n_rounds = np.array([I // 4 + 1, 2, 4])
    jkeys, tkeys = _keys(B, base=99)
    jargs = (_jbatch(d), jnp.asarray(sg), jnp.asarray(dl), jnp.asarray(et),
             jnp.asarray(pr), jnp.asarray(n_rounds.astype(np.int32)), jkeys)
    want = JM.batched_perturbation_phase_stats(*jargs)
    targs = (_tbatch(d), _t(sg), _t(dl), _t(et), _t(pr), n_rounds, tkeys)
    got = TM.batched_perturbation_phase_stats(*targs)
    plain = TM.batched_perturbation_phase(*targs)
    _same_states(got[:3], want[:3])
    _same_probs(got[3], want[3], mode)
    assert int(got[4]) == int(want[4]) > 0
    for a, b in zip(got[:4], plain):
        assert torch.equal(a, b)


def test_perturbation_stats_need_the_fast_ascent(monkeypatch):
    monkeypatch.setattr(TO, "USE_FAST_KERNELS", False)
    d = _bucket(14, B=1, K=16, I=8)
    with pytest.raises(RuntimeError, match="fast-kernel"):
        TM.batched_perturbation_phase_stats(
            _tbatch(d), _t(d["sg0"]), _t(d["dl0"]), _t(d["et0"]),
            torch.zeros(1, dtype=torch.float64), np.array([1]),
            [TR.prng_key(1)])


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_batched_overall_probability_matches_jax(mode):
    d = _bucket(15)
    sg, dl, et, _ = _ascended(d)
    want = JM.batched_overall_probability(
        _jbatch(d), jnp.asarray(sg), jnp.asarray(dl), jnp.asarray(et))
    got = TM.batched_overall_probability(_tbatch(d), _t(sg), _t(dl), _t(et))
    _same_probs(got, want, mode)


@pytest.mark.parametrize("mode", ["split"], indirect=True)
def test_batched_block_flip_matches_jax(mode):
    d = _bucket(16)
    sg, dl, et, _ = _ascended(d)
    want = JM.batched_block_flip(
        _jbatch(d), jnp.asarray(sg), jnp.asarray(dl), jnp.asarray(et),
        jnp.asarray(d["bid"]))
    tb = _tbatch(d)
    got = TM.batched_block_flip(tb, _t(sg), _t(dl), _t(et), _t(d["bid"]))
    _same_states(got[:2], want[:2])
    _same_probs(got[2], want[2], mode)
    # margins are per-site quotients of the same split sums
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=0,
                               atol=SPLIT_ATOL)
    # the in-pass flip score is the standalone scoring program's, bit for bit
    again = TM.batched_overall_probability(tb, got[0], got[1], _t(et))
    assert torch.equal(got[2], again)


def test_split_only_programs_refuse_f64_mode(monkeypatch):
    monkeypatch.setattr(TO, "USE_F32_KERNELS", False)
    d = _bucket(16, B=1, K=16, I=8)
    args = (_tbatch(d), _t(d["sg0"]), _t(d["dl0"]), _t(d["et0"]),
            _t(d["bid"]))
    with pytest.raises(RuntimeError, match="split tables"):
        TM.batched_block_flip(*args)
    with pytest.raises(RuntimeError, match="split tables"):
        TM.batched_phase_fused(*args, np.array([1]), [TR.prng_key(1)])


@pytest.mark.parametrize("mode", ["split"], indirect=True)
def test_batched_phase_fused_matches_jax(mode):
    d = _bucket(17)
    B, I = d["B"], d["I"]
    n_rounds = np.array([I // 4 + 1, 2, I // 4 + 1])
    jkeys, tkeys = _keys(B, base=5)
    want = JM.batched_phase_fused(
        _jbatch(d), jnp.asarray(d["sg0"]), jnp.asarray(d["dl0"]),
        jnp.asarray(d["et0"]), jnp.asarray(d["bid"]),
        jnp.asarray(n_rounds.astype(np.int32)), jkeys)
    got = TM.batched_phase_fused(
        _tbatch(d), _t(d["sg0"]), _t(d["dl0"]), _t(d["et0"]), _t(d["bid"]),
        n_rounds, tkeys)
    _same_states(got[:3], want[:3])
    _same_probs(got[3], want[3], mode)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), rtol=0,
                               atol=SPLIT_ATOL)


@pytest.mark.parametrize("mode", MODES, indirect=True)
def test_batched_enum_cross_optimize_matches_jax(mode):
    """Regions x configs, B = 3: each region's configs share its tables
    (the kernels' members-per-table form)."""
    from longcallr_tpu_torch.phasing.optimize import enumeration_order

    d = _bucket(18, B=3, K=32, I=8)
    I0, C = 5, 32
    d["sm"][:, I0:] = False
    r = np.random.default_rng(180)
    configs = np.pad(enumeration_order(I0).astype(np.float64),
                     ((0, 0), (0, 8 - I0)), constant_values=1.0)
    sig0 = np.where(d["rb"][:, None, :],
                    r.choice([-1.0, 1.0], size=(3, C, 32)), 0.0)
    eta0 = r.choice([-1.0, 0.0, 1.0], size=(3, 8))
    want = JM.batched_enum_cross_optimize(
        _jbatch(d), jnp.asarray(sig0), jnp.asarray(configs),
        jnp.asarray(eta0))
    tb = _tbatch(d)
    got = TM.batched_enum_cross_optimize(tb, _t(sig0), _t(configs), _t(eta0))
    assert got[0].shape == (3, C, 32) and got[3].shape == (3, C)
    _same_states(got[:3], want[:3])
    _same_probs(got[3], want[3], mode)
    # the configs in two chunks, two calls of the ascent program (each
    # builds the tables once for its configs), give the same tensors
    h = C // 2
    parts = [TM.batched_enum_cross_optimize(tb, _t(sig0[:, c:c + h]),
                                            _t(configs[c:c + h]), _t(eta0))
             for c in (0, h)]
    for k, a in enumerate(got):
        assert torch.equal(a, torch.cat([p[k] for p in parts], dim=1))


@pytest.mark.parametrize("mode", ["f64"], indirect=True)
def test_batched_enum_spec_loop_matches_jax(mode, monkeypatch):
    from longcallr_tpu_torch.phasing.optimize import enumeration_order

    monkeypatch.setattr(JO, "USE_FAST_KERNELS", False)
    monkeypatch.setattr(TO, "USE_FAST_KERNELS", False)
    d = _bucket(19, B=2, K=16, I=8)
    r = np.random.default_rng(190)
    configs = np.pad(enumeration_order(3).astype(np.float64),
                     ((0, 0), (0, 5)), constant_values=1.0)
    sig0 = np.where(d["rb"][:, None, :],
                    r.choice([-1.0, 1.0], size=(2, 8, 16)), 0.0)
    eta0 = np.ones((2, 8))
    want = JM.batched_enum_cross_optimize(
        _jbatch(d), jnp.asarray(sig0), jnp.asarray(configs),
        jnp.asarray(eta0))
    got = TM.batched_enum_cross_optimize(_tbatch(d), _t(sig0), _t(configs),
                                         _t(eta0))
    _same_states(got[:3], want[:3])
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=RTOL)


def test_f64_decision_margin_batched_matches_jax():
    d = _bucket(20, B=4, K=48, I=24)
    r = np.random.default_rng(200)
    eta = r.choice([-1.0, 0.0, 1.0], size=(4, 24))
    args = (d["p"], d["q"], d["sg0"], d["dl0"], eta, d["rb"], d["sm"])
    want = np.asarray(JO.f64_decision_margin_batched(*map(jnp.asarray, args)))
    got = TO.f64_decision_margin_batched(*map(_t, args)).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    for b in range(4):
        one = TO.f64_decision_margin_fast(*(_t(a[b]) for a in args))
        np.testing.assert_allclose(got[b], float(one), rtol=1e-12)
    with pytest.raises(ValueError, match=r"\[B,K,I\]"):
        TO.f64_decision_margin_batched(*(_t(a[0]) for a in args))


# --- port against port: fused vs staged, members vs alone -------------------

def test_fused_is_bit_identical_to_staged(monkeypatch):
    """batched_phase_fused is the staged chain composed over one table
    build: phase_regions_batched may pick either per bucket."""
    monkeypatch.setattr(TO, "USE_F32_KERNELS", True)
    d = _bucket(21)
    B, I = d["B"], d["I"]
    tb = _tbatch(d)
    n_rounds = np.array([I // 4 + 1, 3, I // 4 + 1])
    _, tkeys = _keys(B, base=3)
    sg0, dl0, et0, bid = (_t(d[k]) for k in ("sg0", "dl0", "et0", "bid"))
    sg, dl, et, pr1 = TM.batched_cross_optimize(tb, sg0, dl0, et0)
    sg2, dl2, pr2, mg = TM.batched_block_flip(tb, sg, dl, et, bid)
    better = pr2 > pr1 + TO.TIE_TOL
    staged = TM.batched_perturbation_phase(
        tb, torch.where(better[:, None], sg2, sg),
        torch.where(better[:, None], dl2, dl), et,
        torch.where(better, pr2, pr1), n_rounds, tkeys)
    fused = TM.batched_phase_fused(tb, sg0, dl0, et0, bid, n_rounds, tkeys)
    assert torch.equal(fused[4], mg)
    for a, b in zip(fused[:4], staged):
        assert torch.equal(a, b)


@pytest.mark.parametrize("split", [False, True])
def test_a_member_does_not_depend_on_its_bucket_mates(split, monkeypatch):
    """Each program on a bucket of 4 against the same program on member 0
    alone: member 0's state is the same."""
    monkeypatch.setattr(TO, "USE_F32_KERNELS", split)
    d = _bucket(22, B=4)
    I = d["I"]
    one = {k: (v[:1] if isinstance(v, np.ndarray) else v)
           for k, v in d.items()}
    _, tkeys = _keys(4, base=8)
    n_rounds = np.array([I // 4 + 1, 1, 2, 3])
    outs = []
    for dd, keys, nr in ((d, tkeys, n_rounds), (one, tkeys[:1],
                                               n_rounds[:1])):
        tb = _tbatch(dd)
        sg, dl, et, pr = TM.batched_cross_optimize(
            tb, _t(dd["sg0"]), _t(dd["dl0"]), _t(dd["et0"]))
        outs.append(TM.batched_perturbation_phase(tb, sg, dl, et, pr, nr,
                                                  keys))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


# --- phase_regions_batched ----------------------------------------------------

def _sim_region(tmp_path, seed, n_het, n_reads, pkg):
    """(cands, frags) of one simulated region through one package's own
    candidate and fragment stages."""
    rng = np.random.default_rng(seed)
    cfg = (jax_preset if pkg == "jax" else preset)("hifi-masseq").replace(
        min_read_length=100)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=n_het, n_hom=0,
                       min_gap=8500 // (n_het + 1))
    path = str(tmp_path / f"{pkg}{seed}.bam")
    simulate_bam(path, rng, ref, truth, n_reads=n_reads, read_len=4000,
                 err_rate=0.01)
    if pkg == "jax":
        bam = JaxBamFile(path)
        region = JaxRegion(chr="chrS", start=1, end=len(ref) + 1)
        pl = jax_build_pileup(bam, region, ref, cfg)
        cands = JC.select_candidates(pl, cfg)
        return cfg, cands, jax_get_fragments(bam, region, cands, cfg)
    bam = BamFile(path)
    region = Region(chr="chrS", start=1, end=len(ref) + 1)
    pl = build_pileup(bam, region, ref, cfg)
    cands = TC.select_candidates(pl, cfg, device=CPU)
    return cfg, cands, get_fragments(bam, region, cands, cfg)


# (seed, planted hets, reads): two iterative buckets (one of three members
# with different round counts), an enumeration bucket of three, and an
# enumeration region on its own
SPECS = [(1, 14, 60), (2, 14, 50), (5, 20, 60), (8, 20, 20),
         (3, 4, 60), (4, 4, 55), (6, 4, 40), (7, 3, 30)]


def _items(tmp_path, pkg):
    out = []
    for seed, n_het, n_reads in SPECS:
        cfg, cands, frags = _sim_region(tmp_path, seed, n_het, n_reads, pkg)
        out.append((frags, cands, 100 + seed, False))
    return cfg, out


def _census():
    return {k: STAGE_TOTALS.get(k, 0) for k in (
        "phase_buckets", "phase_enum_buckets", "phase_single_regions",
        "phase_fused", "phase_fused_refused", "phase_blockflip_exact",
        "phase_ascent1", "phase_safety_recompute")}


def _delta(before):
    now = _census()
    return {k: now[k] - before[k] for k in now}


def _largest_bucket(titems, cfg):
    """The items of the iterative bucket with most members."""
    groups = {}
    for it in titems:
        K0, I0 = it[0].p.shape
        if I0 > cfg.max_enum_snps:
            groups.setdefault((TO._bucket(K0), TO._bucket(I0)), []).append(it)
    group = max(groups.values(), key=len)
    assert len(group) >= 2
    return group


def _assert_states_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_phase_regions_batched_matches_jax_and_per_region(tmp_path):
    """f64 on the CPU: the port's phase_regions_batched, the JAX package's and the
    port's per-region path give the same state for every region."""
    jcfg, jitems = _items(tmp_path, "jax")
    cfg, titems = _items(tmp_path, "torch")
    for (jf, jc, _, _), (tf, tc, _, _) in zip(jitems, titems):
        np.testing.assert_array_equal(tf.p, jf.p)
    # the bucket of three has members with different round counts
    shapes = [f.p.shape for f, _, _, _ in titems]
    keys = {}
    for K0, I0 in shapes:
        if I0 > cfg.max_enum_snps:
            keys.setdefault((TO._bucket(K0), TO._bucket(I0)), set()).add(
                I0 // 4 + 1)
    assert any(len(v) > 1 for v in keys.values())
    before = _census()
    got = TBD.phase_regions_batched(titems, cfg, device=CPU)
    census = _delta(before)
    assert census["phase_buckets"] == len(keys)
    assert census["phase_enum_buckets"] == 1
    assert census["phase_single_regions"] == 1
    want = JBD.phase_regions_batched(jitems, jcfg)
    _assert_states_equal(got, want)
    alone = [TO.phase_region(f, c, cfg, s, ds, device=CPU)
             for f, c, s, ds in titems]
    _assert_states_equal(got, alone)


def test_phase_regions_batched_split_equals_per_region(tmp_path, monkeypatch):
    """Forced split mode on the CPU (plain versions of the kernels): the
    fused program per bucket equals the per-region split path."""
    cfg, titems = _items(tmp_path, "torch")
    monkeypatch.setattr(TO, "USE_F32_KERNELS", True)
    before = _census()
    got = TBD.phase_regions_batched(titems, cfg, device=CPU)
    census = _delta(before)
    assert census["phase_fused"] > 0 and census["phase_ascent1"] == 0
    alone = [TO.phase_region(f, c, cfg, s, ds, device=CPU)
             for f, c, s, ds in titems]
    _assert_states_equal(got, alone)


def test_region_alone_equals_region_with_three_bucket_mates(tmp_path):
    cfg, titems = _items(tmp_path, "torch")
    group = _largest_bucket(titems, cfg)
    # four members of one bucket: the group, then members again under other
    # seeds (other random streams, so other trajectories)
    mates = group + [(f, c, s + 7 * (n + 1), ds)
                     for n, (f, c, s, ds) in enumerate(group)]
    mates = mates[:4]
    assert len(mates) == 4
    four = TBD.phase_regions_batched(mates, cfg, device=CPU)
    one = TBD.phase_regions_batched(mates[:1], cfg, device=CPU)
    _assert_states_equal(four[:1], one)


def test_empty_items_stay_none(tmp_path):
    cfg, cands, frags = _sim_region(tmp_path, 7, 3, 30, "torch")
    import copy
    none = copy.copy(frags)
    none.p = frags.p[:0]
    out = TBD.phase_regions_batched([(none, cands, 1, False),
                                     (frags, cands, 1, False)], cfg,
                                    device=CPU)
    assert out[0] is None and out[1] is not None


def test_nan_margin_takes_staged_chain_and_exact_host_flip(tmp_path,
                                                           monkeypatch):
    """A NaN block-flip margin counts as unsafe: the fused result is
    refused, the staged chain runs, and the member's flip is recomputed by
    the exact host pass — with the result of the undisturbed run."""
    cfg, titems = _items(tmp_path, "torch")
    items = _largest_bucket(titems, cfg)[:2]
    monkeypatch.setattr(TO, "USE_F32_KERNELS", True)
    want = TBD.phase_regions_batched(items, cfg, device=CPU)
    flip = TKF.fast_block_flip32

    def nan_margin(*a, **kw):
        sg, dl, margin = flip(*a, **kw)
        margin = margin.clone()
        margin[1] = float("nan")
        return sg, dl, margin

    monkeypatch.setattr(TKF, "fast_block_flip32", nan_margin)
    before = _census()
    got = TBD.phase_regions_batched(items, cfg, device=CPU)
    census = _delta(before)
    assert census["phase_fused_refused"] == 1
    assert census["phase_blockflip_exact"] == 1
    assert census["phase_ascent1"] > 0
    _assert_states_equal(got, want)


def test_safety_net_recomputes_a_member_in_f64(tmp_path, monkeypatch):
    """With the bound at infinity every member of every bucket fails it:
    each is recomputed in f64 and counted, and lands on the f64 result."""
    cfg, titems = _items(tmp_path, "torch")
    want = TBD.phase_regions_batched(titems, cfg, device=CPU)     # f64
    monkeypatch.setattr(TO, "split_mode", lambda device: True)
    monkeypatch.setattr(TO, "F32_SAFETY_TOL", np.inf)
    before, n0 = _census(), TO.N_F64_RERUNS
    got = TBD.phase_regions_batched(titems, cfg, device=CPU)
    assert _delta(before)["phase_safety_recompute"] == len(titems) - 1
    assert TO.N_F64_RERUNS - n0 == len(titems)   # the lone region reruns too
    _assert_states_equal(got, want)


def test_giant_regions_leave_the_buckets(tmp_path, monkeypatch):
    cfg, titems = _items(tmp_path, "torch")
    want = TBD.phase_regions_batched(titems, cfg, device=CPU)
    monkeypatch.setattr(giant, "GIANT_CELLS", 1)
    before = _census()
    got = TBD.phase_regions_batched(titems, cfg, device=CPU)
    census = _delta(before)
    n_iter = sum(f.p.shape[1] > cfg.max_enum_snps for f, _, _, _ in titems)
    assert census["phase_buckets"] == 0
    assert census["phase_single_regions"] == n_iter + 1
    _assert_states_equal(got, want)


@pytest.mark.parametrize("knob", ["CPU_BUCKET_B_CAP", "BUCKET_MAX_BYTES"])
def test_cutting_a_bucket_changes_nothing(tmp_path, monkeypatch, knob):
    """A bucket over the CPU member cap or over the byte bound is phased as
    sub-buckets with the same result."""
    cfg, titems = _items(tmp_path, "torch")
    want = TBD.phase_regions_batched(titems, cfg, device=CPU)
    monkeypatch.setattr(TBD, knob, 1)
    before = _census()
    got = TBD.phase_regions_batched(titems, cfg, device=CPU)
    census = _delta(before)
    n_iter = sum(f.p.shape[1] > cfg.max_enum_snps for f, _, _, _ in titems)
    assert census["phase_buckets"] == n_iter
    if knob == "BUCKET_MAX_BYTES":
        assert census["phase_enum_buckets"] == 3
    _assert_states_equal(got, want)


# --- candidates -----------------------------------------------------------------

@pytest.mark.parametrize("cols", [1 << 20, 9000])
def test_select_candidates_batched_matches_per_region_and_jax(tmp_path,
                                                              monkeypatch,
                                                              cols):
    """Columns of several regions through one kernel call (or, with a small
    budget, one call per region): the CandidateSets of the per-region calls
    and of the JAX package's batched call."""
    import dataclasses

    monkeypatch.setattr(TC, "CAND_BATCH_COLS", cols)
    jcfg = jax_preset("hifi-masseq").replace(min_read_length=100)
    cfg = adopt(jcfg)
    jpls, masks = [], []
    for seed, n_het in ((31, 6), (32, 12), (33, 3)):
        rng = np.random.default_rng(seed)
        ref = make_reference(rng, 6000 + 500 * n_het)
        truth = plant_snps(rng, ref, n_het=n_het, n_hom=2, min_gap=300)
        path = str(tmp_path / f"c{seed}.bam")
        simulate_bam(path, rng, ref, truth, n_reads=50, read_len=3000,
                     err_rate=0.01)
        region = JaxRegion(chr="chrS", start=1, end=len(ref) + 1)
        jpls.append(jax_build_pileup(JaxBamFile(path), region, ref, jcfg))
        masks.append(None if seed != 32 else rng.random(len(ref)) < 0.8)
    tpls = [adopt(pl) for pl in jpls]
    got = TC.select_candidates_batched(tpls, cfg, masks, device=CPU)
    want = JC.select_candidates_batched(jpls, jcfg, masks)
    assert len(got) == 3 and sum(c.n for c in got) > 0
    for g, w, pl, em in zip(got, want, tpls, masks):
        one = TC.select_candidates(pl, cfg, exon_mask=em, device=CPU)
        for f in dataclasses.fields(g):
            a = getattr(g, f.name)
            if not isinstance(a, np.ndarray):
                assert a == getattr(w, f.name) == getattr(one, f.name)
            elif a.dtype == np.float64:
                # f64 likelihoods: 1e-12 relative against the JAX package
                # (other libm), equal against the port's per-region call
                np.testing.assert_allclose(a, getattr(w, f.name), rtol=1e-12,
                                           atol=0, err_msg=f.name)
                np.testing.assert_array_equal(a, getattr(one, f.name), f.name)
            else:
                np.testing.assert_array_equal(a, getattr(w, f.name), f.name)
                np.testing.assert_array_equal(a, getattr(one, f.name), f.name)


# --- an enumeration bucket with more members than a CUDA grid dimension ------

def _first_reads(frags, n):
    """The fragment matrix cut to the first n reads that hold a cell."""
    import dataclasses
    keep = np.nonzero((frags.p != 0).any(axis=1))[0][:n]
    per_read = {f.name: getattr(frags, f.name)[keep]
                for f in dataclasses.fields(frags)
                if f.name in ("p", "baseq", "num_hete_links", "for_phasing",
                              "downsampled", "haplotag", "assignment",
                              "assignment_score")}
    return dataclasses.replace(
        frags, qnames=[frags.qnames[i] for i in keep], cells_off=None,
        cells_i=None, cells_p=None, cells_q=None, **per_read)


def test_enum_bucket_of_more_than_65535_members(tmp_path):
    """64 regions of 10 SNPs with 8 reads each are one enumeration bucket
    of K = 8, I = 16 and 1,024 configs a region: one launch carries 65,536
    members. The bucket equals the per-region path and the JAX package's
    batched result."""
    n_regions, seeds = 64, (15, 21, 24, 30)
    items = {"jax": [], "torch": []}
    for pkg in items:
        base = [_sim_region(tmp_path, sd, 10, 60, pkg) for sd in seeds]
        cfg = base[0][0]
        for n in range(n_regions):
            _, cands, frags = base[n % len(seeds)]
            items[pkg].append((_first_reads(frags, 8), cands, 300 + n, False))
        items[pkg] = (cfg, items[pkg])
    (jcfg, jitems), (cfg, titems) = items["jax"], items["torch"]
    for f, c, _, _ in titems:
        assert f.p.shape == (8, 10) and c.n == 10
    K, I_pad, C = TO._bucket(8), TO._bucket(10), 1 << 10
    chunk = min(C, 2 ** 24 // (n_regions * K * I_pad))
    assert n_regions * chunk > 65535
    before = _census()
    got = TBD.phase_regions_batched(titems, cfg, device=CPU)
    census = _delta(before)
    assert census["phase_enum_buckets"] == 1 and census["phase_buckets"] == 0
    alone = [TO.phase_region(f, c, cfg, s, ds, device=CPU)
             for f, c, s, ds in titems]
    _assert_states_equal(got, alone)
    _assert_states_equal(got, JBD.phase_regions_batched(jitems, jcfg))
