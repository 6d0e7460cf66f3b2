"""Phasing kernels and optimizer of the torch port vs the JAX package.

The same seeded numpy inputs go through both packages on the CPU (the
port's split form uses the plain versions of its CUDA kernels there).
Tolerances: f64 sums of the same terms in another order agree to 1e-12
relative; decisions (states, block flips) are TIE_TOL-quantized and must be
equal; the split form's chunked-f32 table reductions agree to 2e-4
absolute, the JAX package's own bound for them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcallr_tpu.config import preset
from longcallr_tpu.io.bam import BamFile
from longcallr_tpu.phasing import kernels as JK
from longcallr_tpu.phasing import kernels_fast as JKF
from longcallr_tpu.phasing import optimize as JO
from longcallr_tpu.tiles.pileup import build_pileup
from longcallr_tpu.tiles.regions import Region
from longcallr_tpu_torch.phasing import kernels as TK
from longcallr_tpu_torch.phasing import kernels_fast as TKF
from longcallr_tpu_torch.phasing import optimize as TO
from simulate import make_reference, plant_snps, simulate_bam

RTOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _data(rng, K=60, I=24):
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(3, 31, size=(K, I)).astype(np.uint8)
    sigma = rng.choice([-1.0, 1.0], size=K)
    delta = rng.choice([-1.0, 1.0], size=I)
    eta = rng.choice([-1.0, 0.0, 0.0, 1.0], size=I)
    site = rng.random(I) < 0.9
    rbase = rng.random(K) < 0.95
    return p, q, sigma, delta, eta, site, rbase


def _tables(p, q):
    return (JK.make_cell_tables(p, q),
            TK.expand_cells(TK.CompactCells.from_numpy(p, q)))


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_expand_cells_bit_equals_host_tables(rng):
    p, q, *_ = _data(rng)
    host = TK.make_cell_tables_np(p, q)
    dev = TK.expand_cells(TK.CompactCells.from_numpy(p, q))
    for a, b in zip(dev, host):
        np.testing.assert_array_equal(a.numpy(), b)
    jh = JK.make_cell_tables_np(p, q)
    for a, b in zip(host, jh):
        np.testing.assert_array_equal(a, b)


def test_spec_kernels_match_jax(rng):
    """read_logliks, snp_sums, snp_qs, overall_probability (reference form)."""
    p, q, sigma, delta, eta, site, rbase = _data(rng)
    jct, tct = _tables(p, q)
    rm = rbase & (sigma != 0)
    want = JK.read_logliks(jct, jnp.asarray(delta), jnp.asarray(eta),
                           jnp.asarray(site)[None, :])
    got = TK.read_logliks(tct, _t(delta), _t(eta), _t(site))
    for g, w in zip(got, want):
        _close(g, w)
    want = JK.snp_sums(jct, jnp.asarray(sigma), jnp.asarray(delta),
                       jnp.asarray(rm), jnp.asarray(site))
    got = TK.snp_sums(tct, _t(sigma), _t(delta), _t(rm), _t(site))
    for g, w in zip(got, want):
        _close(g, w)
    for g, w in zip(TK.snp_qs(*got), JK.snp_qs(*want)):
        _close(g, w)
    _close(TK.snp_q_for(*got, _t(eta)), JK.snp_q_for(*want, jnp.asarray(eta)))
    lp, lm = _t(rng.normal(size=8)) - 5, _t(rng.normal(size=8)) - 5
    sg = _t(rng.choice([-1.0, 1.0], size=8))
    for g, w in zip(TK.sigma_q(lp, lm, sg),
                    JK.sigma_q(jnp.asarray(lp.numpy()), jnp.asarray(lm.numpy()),
                               jnp.asarray(sg.numpy()))):
        _close(g, w)
    want = JK.overall_probability(jct, jnp.asarray(sigma), jnp.asarray(delta),
                                  jnp.asarray(eta), jnp.asarray(rm),
                                  jnp.asarray(site)[None, :])
    got = TK.overall_probability(tct, _t(sigma), _t(delta), _t(eta), _t(rm),
                                 _t(site))
    _close(got, want)


def test_fast_f64_kernels_match_jax(rng):
    p, q, sigma, delta, eta, site, rbase = _data(rng)
    jct, tct = _tables(p, q)
    rm = rbase & (sigma != 0)
    jft = JKF.make_fast_tables(jct, jnp.asarray(rm), jnp.asarray(site))
    tft = TKF.make_fast_tables(tct, _t(rm), _t(site))
    for g, w in zip(tft, jft):
        _close(g, w)
    for g, w in zip(TKF.fast_read_logliks(tft, _t(delta), _t(eta)),
                    JKF.fast_read_logliks(jft, jnp.asarray(delta),
                                          jnp.asarray(eta))):
        _close(g, w)
    for g, w in zip(TKF.fast_snp_sums(tft, _t(sigma), _t(delta)),
                    JKF.fast_snp_sums(jft, jnp.asarray(sigma),
                                      jnp.asarray(delta))):
        _close(g, w)
    _close(TKF.fast_overall_probability(tft, _t(sigma), _t(delta), _t(eta)),
           JKF.fast_overall_probability(jft, jnp.asarray(sigma),
                                        jnp.asarray(delta), jnp.asarray(eta)))


def test_split_kernels_match_jax(rng):
    """Split form: make_fast_tables32 dp2 bit-identical; the split
    half-steps (plain versions on CPU) within the split-mode bound of the
    JAX package's einsum path."""
    p, q, sigma, delta, eta, site, rbase = _data(rng, K=600, I=96)
    jct, tct = _tables(p, q)
    rm = rbase & (sigma != 0)
    jft = JKF.make_fast_tables32(jct, jnp.asarray(rm), jnp.asarray(site))
    tft = TKF.make_fast_tables32(tct, _t(rm), _t(site))
    np.testing.assert_array_equal(tft.dp2.numpy(), np.asarray(jft.dp2))
    f64ft = TKF.make_fast_tables(tct, _t(rm), _t(site))
    # the split matvecs are exact to ~1e-12 against the f64 form
    for g, w in zip(TKF.fast_read_logliks32(tft, _t(delta), _t(eta)),
                    TKF.fast_read_logliks(f64ft, _t(delta), _t(eta))):
        _close(g, w, rtol=1e-12, atol=1e-9)
    for g, w in zip(TKF.fast_snp_sums32(tft, _t(sigma), _t(delta)),
                    JKF.fast_snp_sums32(jft, jnp.asarray(sigma),
                                        jnp.asarray(delta))):
        _close(g, w, rtol=0, atol=2e-4)
    _close(TKF.fast_overall_probability32(tft, _t(sigma), _t(delta), _t(eta)),
           JKF.fast_overall_probability32(jft, jnp.asarray(sigma),
                                          jnp.asarray(delta), jnp.asarray(eta)),
           rtol=1e-6, atol=0)


def test_fast_tables32_from_compact_matches_jax(rng):
    K, I = 600, 96
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(5, 31, size=(K, I)).astype(np.uint8)
    rm = rng.random(K) < 0.9
    sm = rng.random(I) < 0.95
    want = JKF.fast_tables32_from_compact(
        JK.CompactCells(jnp.asarray(p), jnp.asarray(q)), jnp.asarray(rm),
        jnp.asarray(sm))
    got = TKF.fast_tables32_from_compact(TK.CompactCells.from_numpy(p, q),
                                         _t(rm), _t(sm))
    np.testing.assert_array_equal(got.dp2.numpy(), np.asarray(want.dp2))
    _close(got.row_b, want.row_b, rtol=1e-14)
    _close(got.col_b, want.col_b, rtol=1e-14)
    for name in ("row_dif", "col_dif", "col_dp"):
        _close(getattr(got, name), getattr(want, name), rtol=0, atol=2e-4)
    np.testing.assert_array_equal(got.row_cells.numpy(),
                                  np.asarray(want.row_cells))
    np.testing.assert_array_equal(got.cov.numpy(), np.asarray(want.cov))


def _synth_blocks(r, I, n_blocks=5, max_size=4):
    cols = r.permutation(I)
    blocks, block_id = [], np.full(I, -1, np.int32)
    pos = 0
    for bid in range(n_blocks):
        size = int(r.integers(2, max_size + 1))
        if pos + size > I:
            break
        comp = np.sort(cols[pos:pos + size]).astype(np.int64)
        blocks.append(comp)
        block_id[comp] = bid
        pos += size
    return blocks, block_id


@pytest.mark.parametrize("seed", range(4))
def test_block_flip_matches_jax_and_host(seed):
    """fast_block_flip32: decisions equal to the JAX device pass and, when
    the margin clears the envelope, to the exact host pass."""
    r = np.random.default_rng(seed)
    K, I = 72, 28    # one shape: the JAX side compiles its ops once
    hap = r.choice([-1, 1], size=K)
    true_delta = r.choice([-1.0, 1.0], size=I)
    exists = r.random((K, I)) < 0.6
    p = (hap[:, None] * true_delta[None, :]).astype(np.int8)
    p = np.where(r.random((K, I)) < 0.05, -p, p)
    p = np.where(exists, p, 0).astype(np.int8)
    q = r.integers(3, 31, size=(K, I)).astype(np.uint8)
    rbase = r.random(K) < 0.95
    sigma = np.where(rbase, hap.astype(np.float64), 0.0)
    blocks, block_id = _synth_blocks(r, I)
    delta = true_delta.copy()
    for comp in blocks[::2]:
        delta[comp] = -delta[comp]
    eta = np.zeros(I)
    site = r.random(I) < 0.9
    rm = rbase & (sigma != 0)

    jft = JKF.make_fast_tables32(JK.make_cell_tables(p, q), jnp.asarray(rm),
                                 jnp.asarray(site))
    jsg, jdl, jmg = JKF.fast_block_flip32(
        jft, jnp.asarray(p), jnp.asarray(sigma), jnp.asarray(delta),
        jnp.asarray(eta), jnp.asarray(site), jnp.asarray(block_id))
    tct = TK.expand_cells(TK.CompactCells.from_numpy(p, q))
    tft = TKF.make_fast_tables32(tct, _t(rm), _t(site))
    tsg, tdl, tmg = TKF.fast_block_flip32(
        tft, _t(p), _t(sigma), _t(delta), _t(eta), _t(site), _t(block_id))
    np.testing.assert_array_equal(tsg.numpy(), np.asarray(jsg))
    np.testing.assert_array_equal(tdl.numpy(), np.asarray(jdl))
    assert (float(tmg) >= TKF.F32_BF_TOL) == (float(jmg) >= JKF.F32_BF_TOL)
    if float(tmg) >= TKF.F32_BF_TOL:
        ld = TO.LDInfo(pair_ld=None, blocks=blocks, block_id=block_id,
                       adj=None)
        ct_np = TK.make_cell_tables_np(p, q)
        host = TO.block_flip_pass(ct_np, TO.PhaseState(sigma, delta, eta),
                                  rbase, site, ct_np.exists, ld)
        np.testing.assert_array_equal(tsg.numpy(), host.sigma)
        np.testing.assert_array_equal(tdl.numpy(), host.delta)


def test_split_ascent_objective_matches_jax_f32(rng, monkeypatch):
    """Forced split mode (plain versions on the CPU) vs the JAX package's
    forced f32 mode: the same objective to 1e-6 relative, as the JAX
    package's own f32-vs-f64 contract."""
    p, q, sigma, delta, eta, site, rbase = _data(rng, K=512, I=32)
    jct, tct = _tables(p, q)
    sig0 = np.where(rbase, sigma, 0.0)
    cons = np.zeros(32, bool)
    monkeypatch.setattr(JO, "USE_F32_KERNELS", True)
    jst, jprob = JO._cross_optimize_fast_loop(
        jct, JO.PhaseState(jnp.asarray(sig0), jnp.asarray(delta),
                           jnp.asarray(eta)),
        jnp.asarray(rbase), jnp.asarray(site), jnp.asarray(cons), False, False)
    tst, tprob = TO._cross_optimize_fast_loop(
        tct, TO.PhaseState.from_numpy(sig0, delta, eta), _t(rbase), _t(site),
        _t(cons), False, False, split=True)
    np.testing.assert_allclose(float(tprob), float(jprob), rtol=1e-6)
    assert (tst.sigma.numpy() == np.asarray(jst.sigma)).mean() > 0.95


@pytest.mark.parametrize("with_genotype,keep_conserved",
                         [(False, True), (True, False)])
def test_f64_ascent_matches_jax(rng, with_genotype, keep_conserved):
    p, q, sigma, delta, eta, site, rbase = _data(rng, K=80, I=20)
    jct, tct = _tables(p, q)
    sig0 = np.where(rbase, sigma, 0.0)
    cons = rng.random(20) < 0.2
    jst, jprob = JO._cross_optimize_fast_loop(
        jct, JO.PhaseState(jnp.asarray(sig0), jnp.asarray(delta),
                           jnp.asarray(eta)),
        jnp.asarray(rbase), jnp.asarray(site), jnp.asarray(cons),
        with_genotype, keep_conserved)
    for loop in ("fast", "spec"):
        if loop == "fast":
            tst, tprob = TO._cross_optimize_fast_loop(
                tct, TO.PhaseState.from_numpy(sig0, delta, eta), _t(rbase),
                _t(site), _t(cons), with_genotype, keep_conserved, False)
        else:
            tst, tprob = TO._cross_optimize_loop(
                tct, TO.PhaseState.from_numpy(sig0, delta, eta), _t(rbase),
                _t(site), _t(cons), with_genotype, keep_conserved)
        np.testing.assert_allclose(float(tprob), float(jprob), rtol=1e-9)
        for g, w in zip(tst, jst):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_batched_ascent_equals_each_member(rng):
    """A batch of ascents (the enumeration path) equals running each member
    alone: members freeze on their own continue flag."""
    p, q, sigma, delta, eta, site, rbase = _data(rng, K=64, I=12)
    tct = TK.expand_cells(TK.CompactCells.from_numpy(p, q))
    C = 5
    sig0 = np.where(rbase[None, :], rng.choice([-1.0, 1.0], size=(C, 64)), 0.0)
    dl0 = rng.choice([-1.0, 1.0], size=(C, 12))
    cons = np.zeros(12, bool)
    for split in (False, True):
        st, prob = TO.cross_optimize(
            tct, TO.PhaseState.from_numpy(sig0, dl0, np.tile(eta, (C, 1))),
            _t(rbase), _t(site), _t(cons), True, False, split=split)
        for c in range(C):
            s1, p1 = TO.cross_optimize(
                tct, TO.PhaseState.from_numpy(sig0[c], dl0[c], eta),
                _t(rbase), _t(site), _t(cons), True, False, split=split)
            np.testing.assert_allclose(float(prob[c]), float(p1), rtol=1e-12)
            for a, b in zip(st, s1):
                np.testing.assert_array_equal(a[c].numpy(), b.numpy())


def test_perturbation_phase_matches_jax(rng):
    """The schedule with the host threefry draws equals the JAX schedule
    (f64 on both sides): same best state, same objective."""
    K, I = 96, 24
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(10, 31, size=(K, I)).astype(np.uint8)
    rb = rng.random(K) < 0.9
    sig0 = np.where(rb, rng.choice([-1.0, 1.0], K), 0.0)
    dl0 = rng.choice([-1.0, 1.0], I)
    sm = np.ones(I, bool)
    cons = np.zeros(I, bool)
    jct = JK.make_cell_tables(p, q)
    jst0 = JO.PhaseState(jnp.asarray(sig0), jnp.asarray(dl0), jnp.zeros(I))
    jst1, jprob = JO.selected_loop()(jct, jst0, jnp.asarray(rb),
                                     jnp.asarray(sm), jnp.asarray(cons),
                                     False, False)
    seed = 987654321012345
    jb, jp = JO.perturbation_phase(jct, jst1, jst1, jprob, jnp.asarray(rb),
                                   jnp.asarray(sm), jnp.asarray(cons),
                                   jnp.int32(I // 4 + 1),
                                   jax.random.PRNGKey(seed))
    cc = TK.CompactCells.from_numpy(p, q)
    tst1 = TO.PhaseState.from_numpy(*(np.asarray(a) for a in jst1))
    tb, tp = TO.perturbation_phase(cc, tst1, tst1, float(jprob), _t(rb),
                                   _t(sm), _t(cons), I // 4 + 1,
                                   TO.R.prng_key(seed))
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-12)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_decision_margin_matches_jax(rng):
    K, I = 48, 24
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(10, 31, size=(K, I)).astype(np.uint8)
    sigma = rng.choice([-1.0, 1.0], K)
    delta = rng.choice([-1.0, 1.0], I)
    eta = rng.choice([-1.0, 0.0, 1.0], I)
    rb = rng.random(K) < 0.9
    sm = rng.random(I) < 0.9
    want = float(JO.f64_decision_margin_fast(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(sigma), jnp.asarray(delta),
        jnp.asarray(eta), jnp.asarray(rb), jnp.asarray(sm)))
    got = float(TO.f64_decision_margin_fast(
        _t(p), _t(q), _t(sigma), _t(delta), _t(eta), _t(rb), _t(sm)))
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))


def _region(tmp_path, seed, n_het, pkg):
    """(cfg, cands, frags) of one simulated region through the package's own
    candidate and fragment stages."""
    if pkg == "jax":
        from longcallr_tpu.ops.candidates import select_candidates
        from longcallr_tpu.phasing.fragments import get_fragments
    else:
        from longcallr_tpu_torch.ops.candidates import select_candidates
        from longcallr_tpu_torch.phasing.fragments import get_fragments
    rng = np.random.default_rng(seed)
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=n_het, n_hom=0,
                       min_gap=8500 // (n_het + 1))
    path = str(tmp_path / f"{pkg}{seed}.bam")
    simulate_bam(path, rng, ref, truth, n_reads=60, read_len=4000,
                 err_rate=0.01)
    bam = BamFile(path)
    region = Region(chr="chrS", start=1, end=len(ref) + 1)
    pl = build_pileup(bam, region, ref, cfg)
    cands = select_candidates(pl, cfg)
    return cfg, cands, get_fragments(bam, region, cands, cfg)


@pytest.mark.parametrize("n_het,path", [(4, "enumeration"),
                                        (14, "iterative")])
def test_phase_region_matches_jax(tmp_path, n_het, path):
    """phase_region on the CPU (f64) vs the JAX package: equal states."""
    cfg, jc, jf = _region(tmp_path, 31 + n_het, n_het, "jax")
    _, tc, tf = _region(tmp_path, 31 + n_het, n_het, "torch")
    assert (jc.n <= cfg.max_enum_snps) == (path == "enumeration")
    np.testing.assert_array_equal(tf.p, jf.p)
    want = JO.phase_region(jf, jc, cfg, seed=3)
    got = TO.phase_region(tf, tc, cfg, seed=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n_het", [4, 14])
def test_safety_net_reruns_in_f64(tmp_path, n_het, monkeypatch):
    """A split-mode region whose margin fails the bound is recomputed in f64
    on the same device and lands on the f64 result; the rerun is counted."""
    cfg, cands, frags = _region(tmp_path, 51 + n_het, n_het, "torch")
    want = TO.phase_region(frags, cands, cfg, seed=3)
    monkeypatch.setattr(TO, "F32_SAFETY_TOL", np.inf)   # always trigger
    K0, I0 = frags.p.shape
    n0 = TO.N_F64_RERUNS
    st = TO._phase_region_padded_impl(
        frags, cands, cfg, 3, False, K0, I0, TO._bucket(K0), TO._bucket(I0),
        torch.device("cpu"), True).to_numpy()
    assert TO.N_F64_RERUNS == n0 + 1
    np.testing.assert_array_equal(st.sigma[:K0], want.sigma)
    np.testing.assert_array_equal(st.delta[:I0], want.delta)
    np.testing.assert_array_equal(st.eta[:I0], want.eta)


def test_split_mode_and_state_helpers(monkeypatch):
    monkeypatch.setattr(TO, "USE_F32_KERNELS", None)
    assert TO.split_mode(torch.device("cuda")) is True
    assert TO.split_mode(torch.device("cpu")) is False
    monkeypatch.setattr(TO, "USE_F32_KERNELS", True)
    assert TO.split_mode(torch.device("cpu")) is True
    st = TO.PhaseState.from_numpy([1, -1, 0], [1.0], [0.0])
    assert st.sigma.dtype == torch.float64
    np.testing.assert_array_equal(st.to_numpy().sigma, [1.0, -1.0, 0.0])
    cc = TK.CompactCells.from_numpy(np.array([[1, -1]]), np.array([[30, 3]]))
    assert cc.p.dtype == torch.int8 and cc.q.dtype == torch.uint8
    p, q = cc.to_numpy()
    np.testing.assert_array_equal(q, [[30, 3]])
