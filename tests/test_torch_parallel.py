"""The port's multi-device programs, giant-region phasing, the stats variant
of the perturbation schedule and ``--profile-dir`` against the JAX package.

The JAX side runs on its 8 virtual CPU devices (tests/conftest.py); the
port's "devices" are lists of CPU devices, which exercise the same row cuts
and the same shard-order sums as cards would. Tolerances: decisions
(σ, δ, η) equal everywhere; f64 sums 1e-12 relative (a psum and a sum in
shard order add the same terms in another order); an ascent's objective
1e-9 relative, as the JAX package holds its own sharded ascent; cov and
iteration counts exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcallr_tpu.config import preset as jax_preset
from longcallr_tpu.io.bam import BamFile as JaxBamFile
from longcallr_tpu.ops.candidates import select_candidates as jax_select
from longcallr_tpu.parallel import giant as JG
from longcallr_tpu.parallel import mesh as JM
from longcallr_tpu.phasing import kernels as JK
from longcallr_tpu.phasing import optimize as JO
from longcallr_tpu.phasing.fragments import get_fragments as jax_fragments
from longcallr_tpu.tiles.pileup import build_pileup as jax_pileup
from longcallr_tpu.tiles.regions import Region as JaxRegion
from longcallr_tpu_torch import cli
from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.ops.candidates import select_candidates
from longcallr_tpu_torch.parallel import giant as TG
from longcallr_tpu_torch.parallel import mesh as TM
from longcallr_tpu_torch.phasing import kernels as TK
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.phasing import rng as TR
from longcallr_tpu_torch.phasing.fragments import get_fragments
from longcallr_tpu_torch.tiles.pileup import build_pileup
from longcallr_tpu_torch.tiles.regions import Region
from longcallr_tpu_torch.utils.adopt import adopt_batch
from longcallr_tpu_torch.utils.simulate import (make_reference, plant_snps,
                                                simulate_bam)

CPU = torch.device("cpu")
EIGHT = [CPU] * 8


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _need_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


# --- the mesh and the sweep over a bucket ------------------------------------

def test_make_mesh_grid():
    m = TM.make_mesh(4, 2, [torch.device("cpu", i) for i in range(8)])
    assert m.shape == (4, 2) and m.axis_names == ("regions", "reads")
    assert m.devices[1] == (torch.device("cpu", 2), torch.device("cpu", 3))
    assert TM.make_mesh(n_reads_axis=8, devices=EIGHT).shape == (1, 8)
    with pytest.raises(ValueError):
        TM.make_mesh(3, 3, EIGHT)


def _batch(rng, B, K, I):
    p = rng.choice([-1, 0, 1], size=(B, K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(5, 31, size=(B, K, I)).astype(np.uint8)
    rb = rng.random((B, K)) < 0.95
    jbatch = JM.BatchedRegions(p=jnp.asarray(p), q=jnp.asarray(q),
                               read_base=jnp.asarray(rb),
                               site_mask=jnp.ones((B, I), bool),
                               conserved=jnp.asarray(rng.random((B, I)) < 0.2))
    sigma = np.where(rb, rng.choice([-1.0, 1.0], size=(B, K)), 0.0)
    delta = rng.choice([-1.0, 1.0], size=(B, I))
    eta = rng.choice([-1.0, 0.0, 1.0], size=(B, I), p=[0.1, 0.8, 0.1])
    return jbatch, sigma, delta, eta


@pytest.mark.parametrize("mesh_shape", [None, (4, 2)])
@pytest.mark.parametrize("with_genotype,keep_conserved",
                         [(True, False), (False, True)])
def test_batched_phase_step_matches_jax(rng, mesh_shape, with_genotype,
                                        keep_conserved):
    """One sweep over a bucket of 8 regions, with no mesh and cut over a
    (4, 2) grid (4 chunks along "regions"), equals the JAX sweep."""
    _need_8()
    B, K, I = 8, 32, 8
    jbatch, sigma, delta, eta = _batch(rng, B, K, I)
    jmesh = tmesh = None
    if mesh_shape is not None:
        jmesh = JM.make_mesh(*mesh_shape)
        tmesh = TM.make_mesh(*mesh_shape, devices=EIGHT)
    want = JM.batched_phase_step(jbatch, jnp.asarray(sigma),
                                 jnp.asarray(delta), jnp.asarray(eta),
                                 with_genotype=with_genotype,
                                 keep_conserved=keep_conserved, mesh=jmesh)
    got = TM.batched_phase_step(adopt_batch(jbatch, CPU), _t(sigma),
                                _t(delta), _t(eta),
                                with_genotype=with_genotype,
                                keep_conserved=keep_conserved, mesh=tmesh)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if mesh_shape is not None:
        plain = TM.batched_phase_step(adopt_batch(jbatch, CPU), _t(sigma),
                                      _t(delta), _t(eta),
                                      with_genotype=with_genotype,
                                      keep_conserved=keep_conserved)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)


# --- reads-sharded sums and ascent ------------------------------------------

def test_read_sharded_snp_sums_match_jax(rng):
    _need_8()
    K, I = 64, 16
    p = rng.choice([-1.0, 0.0, 1.0], size=(K, I))
    lerr = np.where(p != 0, -1.5 - rng.random((K, I)), 0.0)
    l1m = np.where(p != 0, -0.02 * rng.random((K, I)), 0.0)
    sigma = rng.choice([-1.0, 1.0], size=K)
    rm = rng.random(K) < 0.9
    sm = rng.random(I) < 0.9
    dl = rng.choice([-1.0, 1.0], size=I)
    want = JM.read_sharded_snp_sums(JM.make_mesh(1, 8))(
        *(jnp.asarray(a) for a in (p, lerr, l1m, sigma, rm, sm, dl)))
    got = TM.read_sharded_snp_sums(TM.make_mesh(1, 8, EIGHT))(
        p, lerr, l1m, sigma, rm, sm, dl)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert got[4].dtype == torch.int64


@pytest.mark.parametrize("with_genotype,keep_conserved",
                         [(True, False), (False, True), (False, False)])
def test_sharded_cross_optimize_matches_jax(rng, with_genotype,
                                            keep_conserved):
    """The reads-sharded ascent on 8 shards against the JAX shard_map
    program on the 8-device mesh: the same decisions, prob to 1e-9."""
    _need_8()
    K, I = 128, 24
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(3, 31, size=(K, I)).astype(np.uint8)
    rb = rng.random(K) < 0.95
    sigma0 = np.where(rb, np.where(rng.random(K) < 0.5, -1.0, 1.0), 0.0)
    delta0 = rng.choice([-1.0, 1.0], size=I)
    eta0 = rng.choice([-1.0, 0.0, 1.0], size=I, p=[0.1, 0.8, 0.1])
    sm = rng.random(I) < 0.95
    cons = rng.random(I) < 0.2
    args = (p, q, sigma0, delta0, eta0, rb, sm, cons)
    jfn = JM.sharded_cross_optimize(JM.make_mesh(1, 8),
                                    with_genotype=with_genotype,
                                    keep_conserved=keep_conserved)
    want = jfn(*(jnp.asarray(a) for a in args))
    tfn = TM.sharded_cross_optimize(EIGHT, with_genotype=with_genotype,
                                    keep_conserved=keep_conserved)
    got = tfn(*args)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-9)
    # the shard count does not change the result
    one = TM.sharded_cross_optimize([CPU], with_genotype=with_genotype,
                                    keep_conserved=keep_conserved)(*args)
    for a, b in zip(got[:3], one[:3]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(got[3]), float(one[3]), rtol=1e-12)


def test_reads_devices_on_the_cpu_is_none():
    assert TG.reads_devices(CPU) is None
    with pytest.raises(ValueError):
        TG.phase_region_sharded(None, None, None, 0, devices=[])


# --- giant regions ------------------------------------------------------------

def _giant_region(tmp_path, rng):
    """The region of tests/test_parallel.py::test_phase_region_sharded_truth
    (18 hets over 9 kb, 80 reads of 4 kb) through both packages' own
    candidate and fragment stages."""
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    jcfg = jax_preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=18, n_hom=0, min_gap=8000 // 19)
    path = str(tmp_path / "giant.bam")
    simulate_bam(path, rng, ref, truth, n_reads=80, read_len=4000,
                 err_rate=0.01)
    jbam = JaxBamFile(path)
    jreg = JaxRegion(chr="chrS", start=1, end=len(ref) + 1)
    jc = jax_select(jax_pileup(jbam, jreg, ref, jcfg), jcfg)
    jf = jax_fragments(jbam, jreg, jc, jcfg)
    bam = BamFile(path)
    reg = Region(chr="chrS", start=1, end=len(ref) + 1)
    tc = select_candidates(build_pileup(bam, reg, ref, cfg), cfg, device=CPU)
    tf = get_fragments(bam, reg, tc, cfg)
    assert tc.n > cfg.max_enum_snps        # iterative path
    np.testing.assert_array_equal(tf.p, jf.p)
    return cfg, jcfg, (jc, jf), (tc, tf)


def test_phase_region_sharded_matches_jax(tmp_path, rng):
    """phase_region_sharded on 8 shards against the JAX function on its
    8-device mesh: the same padded state; a rerun is the same again."""
    _need_8()
    cfg, jcfg, (jc, jf), (tc, tf) = _giant_region(tmp_path, rng)
    want = JG.phase_region_sharded(jf, jc, jcfg, 1, False, JG.reads_mesh())
    got = TG.phase_region_sharded(tf, tc, cfg, 1, False, EIGHT)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    again = TG.phase_region_sharded(tf, tc, cfg, 1, False, [CPU, CPU])
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a, b)


def test_phase_region_routes_giant_regions(tmp_path, rng, monkeypatch):
    """With GIANT_CELLS = 0 and a process of 8 "cards", phase_region takes
    the reads-sharded ascent, as the JAX package's phase_region does on its
    8 virtual devices; the sliced states are equal."""
    _need_8()
    cfg, jcfg, (jc, jf), (tc, tf) = _giant_region(tmp_path, rng)
    monkeypatch.setattr(JG, "GIANT_CELLS", 0)
    want = JO.phase_region(jf, jc, jcfg, seed=1)
    calls = []
    orig = TG.phase_region_sharded

    def spy(*a, **kw):
        calls.append(a[-1])
        return orig(*a, **kw)

    monkeypatch.setattr(TG, "GIANT_CELLS", 0)
    monkeypatch.setattr(TG, "reads_devices", lambda device: EIGHT)
    monkeypatch.setattr(TG, "phase_region_sharded", spy)
    got = TO.phase_region(tf, tc, cfg, seed=1, device=CPU)
    assert calls == [EIGHT], "giant routing not taken"
    assert got.sigma.shape == (tf.p.shape[0],)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


# --- the perturbation schedule with trip accounting -------------------------

def test_perturbation_phase_stats_matches_jax(rng):
    """perturbation_phase_stats against the JAX function (f64 on both
    sides): the same best state and iteration count, prob to 1e-12; state
    and prob equal the port's perturbation_phase."""
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
    seed = 123456789012345
    jb, jp, jit = JO.perturbation_phase_stats(
        jct, jst1, jst1, jprob, jnp.asarray(rb), jnp.asarray(sm),
        jnp.asarray(cons), jnp.int32(I // 4 + 1), jax.random.PRNGKey(seed))
    cc = TK.CompactCells.from_numpy(p, q)
    tst1 = TO.PhaseState.from_numpy(*(np.asarray(a) for a in jst1))
    args = (cc, tst1, tst1, float(jprob), _t(rb), _t(sm), _t(cons),
            I // 4 + 1, TR.prng_key(seed))
    tb, tp, tit = TO.perturbation_phase_stats(*args)
    assert tit == int(jit) and tit >= 2 * (I // 4 + 1)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-12)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    pb, pp = TO.perturbation_phase(*args)
    assert float(pp) == float(tp)
    for a, b in zip(pb, tb):
        assert torch.equal(a, b)


# --- --profile-dir -------------------------------------------------------------

def test_profile_dir_writes_a_trace_and_the_same_bytes(tmp_path):
    rng = np.random.default_rng(41)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=10, n_hom=1, min_gap=400)
    bam = str(tmp_path / "prof.bam")
    simulate_bam(bam, rng, ref, truth, n_reads=60, read_len=2500,
                 err_rate=0.01)
    base = ["-b", bam, "-f", str(tmp_path / "prof.fa"), "-p", "hifi-masseq",
            "--platform", "cpu", "--min-read-length", "100"]
    assert cli.main(base + ["-o", str(tmp_path / "plain")]) == 0
    trace_dir = tmp_path / "trace"
    assert cli.main(base + ["-o", str(tmp_path / "prof"), "--profile-dir",
                            str(trace_dir)]) == 0
    traces = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and os.path.getsize(trace_dir / traces[0]) > 0
    for ext in (".vcf", ".phased.bam"):
        with open(tmp_path / f"plain{ext}", "rb") as a, \
                open(tmp_path / f"prof{ext}", "rb") as b:
            assert a.read() == b.read()
