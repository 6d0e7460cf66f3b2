"""The regions axis of the mesh against the JAX package.

The JAX side runs its programs, ``phase_regions_batched`` and ``caller.run``
with ``mesh=`` a (regions, reads) grid of its 8 virtual CPU devices
(tests/conftest.py); the port's mesh is the same grid of the CPU device
eight times, which exercises the same cut of a bucket into rows and the
same threads as cards would. Meshes: (4, 2) with a bucket of 5 (rows of
1 and 2 regions) and (8, 1) with a bucket of 3 (empty rows).

Tolerances. States, masks, round and trip counts: equal everywhere. f64
objectives (the CPU's mode): 1e-12 relative. The block flip and the fused
phase exist in split mode only, so both packages are forced into it there:
states equal, sums within 1e-4 absolute of the JAX package's (its f32
chunk partials against the port's f64 sums, the bound of
tests/test_torch_batched.py), and within 1e-12 relative of the port's own
run without a mesh. Outputs of the batch driver and of ``caller.run``: equal
states, VCF lines and bytes, read assignments, phase sets and HP/PS tags.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcallr_tpu.config import preset as jax_preset
from longcallr_tpu.io.bam import BamFile as JaxBamFile
from longcallr_tpu.io.fasta import FastaFile as JaxFastaFile
from longcallr_tpu.parallel import mesh as JM
from longcallr_tpu.phasing import batch_driver as JBD
from longcallr_tpu.phasing import kernels as JK
from longcallr_tpu.phasing import optimize as JO
from longcallr_tpu.pipeline import engine as JE
from longcallr_tpu.pipeline.caller import run as jax_run
from longcallr_tpu.tiles.regions import Region as JaxRegion
from longcallr_tpu.tiles.regions import \
    find_isolated_regions_with_depth as jax_find_regions
from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.io.bgzf import decompress_file
from longcallr_tpu_torch.io.fasta import FastaFile
from longcallr_tpu_torch.parallel import mesh as TM
from longcallr_tpu_torch.phasing import batch_driver as TBD
from longcallr_tpu_torch.phasing import cuda_kernels as CK
from longcallr_tpu_torch.phasing import kernels as TK
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.phasing import rng as TR
from longcallr_tpu_torch.pipeline import engine as TE
from longcallr_tpu_torch.pipeline.caller import run
from longcallr_tpu_torch.tiles.regions import (
    Region, find_isolated_regions_with_depth)
from longcallr_tpu_torch.utils import device as placement
from longcallr_tpu_torch.utils import goldens
from longcallr_tpu_torch.utils.bench_workload import (make_deep_workload,
                                                      make_genome_workload)
from longcallr_tpu_torch.utils.simulate import (make_reference, plant_snps,
                                                simulate_bam)

CPU = torch.device("cpu")
EIGHT = [CPU] * 8
RTOL = 1e-12
SPLIT_ATOL = 1e-4
# (mesh shape, bucket size): uneven rows, and rows left empty
MESHES = [((4, 2), 5), ((8, 1), 3)]


def _need_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _t(a):
    return torch.as_tensor(np.array(a))


def _meshes(shape):
    _need_8()
    return JM.make_mesh(*shape), TM.make_mesh(*shape, devices=EIGHT)


@pytest.fixture
def split_mode(monkeypatch):
    """Both packages forced into split mode (the JAX jit caches cleared
    around it: the mode is resolved at trace time)."""
    monkeypatch.setattr(JO, "USE_F32_KERNELS", True)
    monkeypatch.setattr(TO, "USE_F32_KERNELS", True)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _bucket(seed, B, K=32, I=16):
    """A planted bucket: reads on one of two haplotypes with 5 % cell
    noise, so ascents, flips and perturbations do real work."""
    r = np.random.default_rng(seed)
    hap = r.choice([-1, 1], size=(B, K))
    td = r.choice([-1.0, 1.0], size=(B, I))
    exists = r.random((B, K, I)) < 0.6
    p = (hap[:, :, None] * td[:, None, :]).astype(np.int8)
    p = np.where(r.random((B, K, I)) < 0.05, -p, p)
    p = np.where(exists, p, 0).astype(np.int8)
    bid = np.full((B, I), -1, np.int32)
    bid[:, 0:3], bid[:, 4:6], bid[:, 9:12] = 0, 1, 2
    rb = r.random((B, K)) < 0.95
    return dict(p=p, q=r.integers(3, 31, size=(B, K, I)).astype(np.uint8),
                rb=rb, sm=r.random((B, I)) < 0.95,
                cons=r.random((B, I)) < 0.15,
                sg0=np.where(rb, r.choice([-1.0, 1.0], size=(B, K)), 0.0),
                dl0=r.choice([-1.0, 1.0], size=(B, I)), et0=np.zeros((B, I)),
                bid=bid, B=B, K=K, I=I,
                rounds=np.array([I // 4 + 1, 1, 3, 5, 2][:B] + [4] * (B - 5)))


def _batches(d):
    jb = JM.BatchedRegions(p=jnp.asarray(d["p"]), q=jnp.asarray(d["q"]),
                           read_base=jnp.asarray(d["rb"]),
                           site_mask=jnp.asarray(d["sm"]),
                           conserved=jnp.asarray(d["cons"]))
    tb = TM.BatchedRegions.from_numpy(d["p"], d["q"], d["rb"], d["sm"],
                                      d["cons"], CPU)
    return jb, tb


def _keys(B, base=7):
    seeds = [base + 1000003 * b for b in range(B)]
    return (jnp.stack([jax.random.PRNGKey(s) for s in seeds]),
            [TR.prng_key(s) for s in seeds])


def _check(got, plain, want, n_states, split=False):
    """Port with a mesh against the port without and against JAX: the
    first ``n_states`` outputs equal, the rest (probs, margins) within
    the tolerances of the module docstring."""
    assert len(got) == len(plain) == len(want)
    for k, (g, p, w) in enumerate(zip(got, plain, want)):
        g, p, w = g.numpy(), p.numpy(), np.asarray(w)
        if k < n_states:
            np.testing.assert_array_equal(g, p)
            np.testing.assert_array_equal(g, w)
            continue
        np.testing.assert_allclose(g, p, rtol=RTOL, atol=0)
        if split:
            np.testing.assert_allclose(g, w, rtol=0, atol=SPLIT_ATOL)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0)


def _ascended(d, jb):
    sg, dl, et, pr = JM.batched_cross_optimize(
        jb, jnp.asarray(d["sg0"]), jnp.asarray(d["dl0"]),
        jnp.asarray(d["et0"]))
    return tuple(np.asarray(a) for a in (sg, dl, et, pr))


# --- the seven bucket programs -------------------------------------------------

@pytest.mark.parametrize("shape,B", MESHES)
def test_batched_cross_optimize_on_mesh(shape, B):
    jmesh, tmesh = _meshes(shape)
    d = _bucket(11, B)
    jb, tb = _batches(d)
    args = (d["sg0"], d["dl0"], d["et0"])
    want = JM.batched_cross_optimize(jb, *map(jnp.asarray, args), mesh=jmesh)
    plain = TM.batched_cross_optimize(tb, *map(_t, args))
    got = TM.batched_cross_optimize(tb, *map(_t, args), mesh=tmesh)
    _check(got, plain, want, 3)


@pytest.mark.parametrize("shape,B", MESHES)
def test_batched_perturbation_phase_on_mesh(shape, B):
    """Per-region round counts that differ between rows: every row runs
    the bucket's loop, a member past its count keeps its state."""
    jmesh, tmesh = _meshes(shape)
    d = _bucket(13, B)
    jb, tb = _batches(d)
    sg, dl, et, pr = _ascended(d, jb)
    jkeys, tkeys = _keys(B)
    want = JM.batched_perturbation_phase(
        jb, *map(jnp.asarray, (sg, dl, et, pr)),
        jnp.asarray(d["rounds"].astype(np.int32)), jkeys, mesh=jmesh)
    plain = TM.batched_perturbation_phase(tb, *map(_t, (sg, dl, et, pr)),
                                          d["rounds"], tkeys)
    got = TM.batched_perturbation_phase(tb, *map(_t, (sg, dl, et, pr)),
                                        d["rounds"], tkeys, mesh=tmesh)
    _check(got, plain, want, 3)


@pytest.mark.parametrize("shape,B", MESHES)
def test_batched_perturbation_phase_stats_on_mesh(shape, B):
    """``iters`` with a mesh: per ascent call the most trips of any row,
    summed — the count of the bucket without a mesh and of the JAX
    program."""
    jmesh, tmesh = _meshes(shape)
    d = _bucket(14, B)
    jb, tb = _batches(d)
    sg, dl, et, pr = _ascended(d, jb)
    jkeys, tkeys = _keys(B, base=9)
    want = JM.batched_perturbation_phase_stats(
        jb, *map(jnp.asarray, (sg, dl, et, pr)),
        jnp.asarray(d["rounds"].astype(np.int32)), jkeys, mesh=jmesh)
    plain = TM.batched_perturbation_phase_stats(
        tb, *map(_t, (sg, dl, et, pr)), d["rounds"], tkeys)
    got = TM.batched_perturbation_phase_stats(
        tb, *map(_t, (sg, dl, et, pr)), d["rounds"], tkeys, mesh=tmesh)
    _check(got[:4], plain[:4], want[:4], 3)
    assert isinstance(got[4], int)
    assert got[4] == plain[4] == int(want[4]) > 0


@pytest.mark.parametrize("shape,B", MESHES)
def test_batched_overall_probability_on_mesh(shape, B):
    jmesh, tmesh = _meshes(shape)
    d = _bucket(15, B)
    jb, tb = _batches(d)
    sg, dl, et, _ = _ascended(d, jb)
    want = JM.batched_overall_probability(jb, *map(jnp.asarray, (sg, dl, et)),
                                          mesh=jmesh)
    plain = TM.batched_overall_probability(tb, *map(_t, (sg, dl, et)))
    got = TM.batched_overall_probability(tb, *map(_t, (sg, dl, et)),
                                         mesh=tmesh)
    _check((got,), (plain,), (want,), 0)


@pytest.mark.parametrize("shape,B", MESHES)
def test_batched_block_flip_on_mesh(shape, B, split_mode):
    jmesh, tmesh = _meshes(shape)
    d = _bucket(16, B)
    jb, tb = _batches(d)
    sg, dl, et, _ = _ascended(d, jb)
    want = JM.batched_block_flip(jb, *map(jnp.asarray, (sg, dl, et)),
                                 jnp.asarray(d["bid"]), mesh=jmesh)
    plain = TM.batched_block_flip(tb, *map(_t, (sg, dl, et, d["bid"])))
    got = TM.batched_block_flip(tb, *map(_t, (sg, dl, et, d["bid"])),
                                mesh=tmesh)
    _check(got, plain, want, 2, split=True)


@pytest.mark.parametrize("shape,B", MESHES)
def test_batched_phase_fused_on_mesh(shape, B, split_mode):
    """The fused phase returns every row's margins, so the caller's
    fused-or-staged decision sees the whole bucket."""
    jmesh, tmesh = _meshes(shape)
    d = _bucket(17, B)
    jb, tb = _batches(d)
    jkeys, tkeys = _keys(B, base=3)
    args = (d["sg0"], d["dl0"], d["et0"], d["bid"])
    want = JM.batched_phase_fused(jb, *map(jnp.asarray, args),
                                  jnp.asarray(d["rounds"].astype(np.int32)),
                                  jkeys, mesh=jmesh)
    plain = TM.batched_phase_fused(tb, *map(_t, args), d["rounds"], tkeys)
    got = TM.batched_phase_fused(tb, *map(_t, args), d["rounds"], tkeys,
                                 mesh=tmesh)
    _check(got, plain, want, 3, split=True)
    assert got[4].shape == (B,)


@pytest.mark.parametrize("shape,B", MESHES)
def test_batched_enum_cross_optimize_on_mesh(shape, B):
    """sigma0 [B, C, K] and eta0 are cut with the regions, the configs go
    whole to every row, and each row's ascent program builds its regions'
    tables once for their configs."""
    jmesh, tmesh = _meshes(shape)
    d = _bucket(18, B, K=16, I=8)
    jb, tb = _batches(d)
    I0 = 4
    configs = TO.enumeration_order(I0).astype(np.float64)
    configs = np.pad(configs, ((0, 0), (0, d["I"] - I0)), constant_values=1.0)
    r = np.random.default_rng(18)
    sig0 = np.where(d["rb"][:, None, :],
                    np.where(r.random((B, configs.shape[0], d["K"])) < 0.5,
                             -1.0, 1.0), 0.0)
    eta0 = np.ones((B, d["I"]))
    want = JM.batched_enum_cross_optimize(
        jb, jnp.asarray(sig0), jnp.asarray(configs), jnp.asarray(eta0),
        mesh=jmesh)
    plain = TM.batched_enum_cross_optimize(tb, _t(sig0), _t(configs),
                                           _t(eta0))
    rows = TM.shard_regions(tb, tmesh)
    got = TM.batched_enum_cross_optimize(rows, _t(sig0), _t(configs),
                                         _t(eta0), mesh=tmesh)
    _check(got, plain, want, 3)


# --- the cut, the threads, the launch counts -----------------------------------

def test_shard_regions_cuts_like_linspace():
    _need_8()
    d = _bucket(19, 3)
    _, tb = _batches(d)
    rows = TM.shard_regions(tb, TM.make_mesh(8, 1, EIGHT))
    assert rows.rows == (2, 5, 7)           # linspace(0, 3, 9) as int
    assert rows.bounds == ((0, 1), (1, 2), (2, 3))
    for (b0, b1), share in zip(rows.bounds, rows.batches):
        for a, w in zip(share, tb):
            assert torch.equal(a, w[b0:b1])
    host = TM.shard_regions(TM.BatchedRegions(
        d["p"], d["q"], d["rb"], d["sm"], d["cons"]), TM.make_mesh(
            4, 2, EIGHT))
    assert host.bounds == ((0, 1), (1, 2), (2, 3))
    assert host.batches[0].p.dtype == torch.int8


def test_a_mesh_of_mixed_devices_raises():
    with pytest.raises(ValueError, match="one type"):
        TM.make_mesh(2, 1, [CPU, torch.device("cuda", 0)])
    mixed = TM.Mesh(((CPU,), (torch.device("cuda", 0),)))
    d = _bucket(20, 2)
    with pytest.raises(ValueError, match="one type"):
        TM.shard_regions(_batches(d)[1], mixed)


def test_rows_run_in_a_thread_each():
    """Every non-empty row runs in a host thread of its own, with its
    launches counted for its row; the only row runs in the caller's."""
    _need_8()
    d = _bucket(21, 5)
    _, tb = _batches(d)
    seen, lock = [], threading.Lock()
    barrier = threading.Barrier(4, timeout=30)

    def record(i, share, sg, shared):
        barrier.wait()                  # all four rows are running at once
        with lock:
            seen.append((i, threading.get_ident(),
                         getattr(CK._launch_row, "index", None),
                         share.p.shape[0], sg.shape[0], shared.shape))
        return (sg * 2,)

    rows = TM.shard_regions(tb, TM.make_mesh(4, 2, EIGHT))
    sg = torch.arange(5.0)
    out = TM._run_rows(rows, record, (sg,), (torch.ones(3),), CPU)
    assert [o[0].tolist() for o in out] == [[0.0], [2.0], [4.0], [6.0, 8.0]]
    assert len({t for _, t, *_ in seen}) == 4
    assert threading.get_ident() not in {t for _, t, *_ in seen}
    assert sorted((i, row, n, m, s) for i, _, row, n, m, s in seen) == [
        (0, 0, 1, 1, (3,)), (1, 1, 1, 1, (3,)), (2, 2, 1, 1, (3,)),
        (3, 3, 2, 2, (3,))]
    assert getattr(CK._launch_row, "index", None) is None
    one = TM.shard_regions(tb, TM.make_mesh(1, 8, EIGHT))
    idents = TM._run_rows(one, lambda i, share: (threading.get_ident(),))
    assert idents == [(threading.get_ident(),)]


def test_a_failing_row_raises_after_every_row_ended():
    _need_8()
    _, tb = _batches(_bucket(22, 4))
    ended = []

    def fn(i, share):
        if i == 1:
            raise RuntimeError("row 1 failed")
        ended.append(i)
        return ()

    with pytest.raises(RuntimeError, match="row 1 failed"):
        TM._run_rows(TM.shard_regions(tb, TM.make_mesh(4, 2, EIGHT)), fn)
    assert sorted(ended) == [0, 2, 3]


# --- the batch driver and the caller ------------------------------------------

def _dryrun_items(tmp_path, pkg):
    """The end-to-end workload of the JAX package's multi-device dry run
    (four iterative regions of 2.4 kb at 30x) through one package's
    prepare, and the regions."""
    bam_p, fa_p = str(tmp_path / "tiny.bam"), str(tmp_path / "tiny.fa")
    make_deep_workload(bam_p, fa_p, n_regions=4, region_len=2400,
                       snp_spacing=120, coverage=30, read_len=600,
                       err_rate=0.0, gap=3000, seed=20_260_818, contig="chrT")
    # each package prepares its own copy: finalize changes frags and cands
    if pkg == "jax":
        cfg = jax_preset("hifi-masseq").replace(min_read_length=100)
        bam, ref = JaxBamFile(bam_p), JaxFastaFile(fa_p).fetch("chrT")
        regions = jax_find_regions(bam, "chrT", len(ref), cfg)
        prep = lambda rg: JE.prepare_region(bam, rg, ref, cfg)
    else:
        cfg = preset("hifi-masseq").replace(min_read_length=100)
        bam, ref = BamFile(bam_p), FastaFile(fa_p).fetch("chrT")
        regions = find_isolated_regions_with_depth(bam, "chrT", len(ref), cfg)
        prep = lambda rg: TE.prepare_region(bam, rg, ref, cfg, CPU)
    items, regs = [], []
    for rg in regions:
        cands, frags, apply_ds = prep(rg)
        if cands.n > 0 and frags.n_frags > 0:
            items.append((frags, cands, rg.start, apply_ds))
            regs.append(rg)
    return cfg, items, regs


def _enum_items(tmp_path, pkg):
    """Three loci of four SNPs (an enumeration bucket) and one of three
    (an enumeration region alone), each simulated and taken through one
    package's candidate and fragment stages."""
    out = []
    for seed, n_het, n_reads in ((3, 4, 60), (4, 4, 55), (6, 4, 40),
                                 (7, 3, 30)):
        rng = np.random.default_rng(seed)
        ref = make_reference(rng, 9000)
        truth = plant_snps(rng, ref, n_het=n_het, n_hom=0,
                           min_gap=8500 // (n_het + 1))
        path = str(tmp_path / f"{pkg}{seed}.bam")
        simulate_bam(path, rng, ref, truth, n_reads=n_reads, read_len=4000,
                     err_rate=0.01)
        if pkg == "jax":
            cfg = jax_preset("hifi-masseq").replace(min_read_length=100)
            rg = JaxRegion(chr="chrS", start=1, end=len(ref) + 1)
            cands, frags, _ = JE.prepare_region(JaxBamFile(path), rg, ref,
                                                cfg)
        else:
            cfg = preset("hifi-masseq").replace(min_read_length=100)
            rg = Region(chr="chrS", start=1, end=len(ref) + 1)
            cands, frags, _ = TE.prepare_region(BamFile(path), rg, ref, cfg,
                                                CPU)
        out.append((frags, cands, 100 + seed, False))
    return out


def _finalized(cfg, items, regs, states, finalize):
    outs = []
    for (frags, cands, _, apply_ds), rg, st in zip(items, regs, states):
        outs.append(finalize(rg, cands, frags, st, cfg, apply_ds))
    return [(o.vcf_lines, o.read_assignments, o.phase_sets) for o in outs]


def test_phase_regions_batched_on_mesh_matches_jax(tmp_path):
    """The JAX package's dry-run workload plus an enumeration mix through
    phase_regions_batched on a (4, 2) mesh: states equal the JAX mesh's
    and the port's without a mesh; through finalize_region the VCF lines,
    read assignments and phase sets are equal."""
    jmesh, tmesh = _meshes((4, 2))
    jcfg, jitems, jregs = _dryrun_items(tmp_path, "jax")
    cfg, titems, tregs = _dryrun_items(tmp_path, "torch")
    assert len(titems) >= 4
    assert all(it[1].n > cfg.max_enum_snps for it in titems)
    jenum, tenum = _enum_items(tmp_path, "jax"), _enum_items(tmp_path, "torch")
    jall, tall = jitems + jenum, titems + tenum
    want = JBD.phase_regions_batched(jall, jcfg, mesh=jmesh)
    plain = TBD.phase_regions_batched(tall, cfg, device=CPU)
    before = dict(TE.STAGE_TOTALS), dict(placement.PLACEMENTS)
    got = TBD.phase_regions_batched(tall, cfg, device=CPU, mesh=tmesh)
    made = {k: TE.STAGE_TOTALS.get(k, 0) - before[0].get(k, 0)
            for k in ("phase_buckets", "phase_enum_buckets",
                      "phase_single_regions")}
    assert made == {"phase_buckets": 1, "phase_enum_buckets": 1,
                    "phase_single_regions": 1}
    # the router saw the region phased alone, no bucket of the mesh
    routed = sum(placement.PLACEMENTS.values()) - sum(before[1].values())
    assert routed == 1
    for g, p, w in zip(got, plain, want):
        for a, b, c in zip(g, p, w):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, np.asarray(c))
    n = len(titems)
    t_out = _finalized(cfg, titems, tregs, got[:n], TE.finalize_region)
    j_out = _finalized(jcfg, jitems, jregs, want[:n], JE.finalize_region)
    assert t_out == j_out
    assert sum(len(v) for v, _, _ in t_out) > 0
    assert sum(1 for _, a, _ in t_out for v in a.values() if v) > 0


GENOME = [("chrA", [(6000, 20, 160), (5000, 30, 200)]),
          ("chrB", [(6000, 60, 200), (4000, 25, 150)]),
          ("chrC", [(5000, 20, 160), (5000, 20, 1300), (4000, 40, 1500)])]


def test_caller_run_on_mesh_matches_jax(tmp_path):
    """caller.run(batched=True, mesh=) on the (4, 2) mesh against the JAX
    package's with its (4, 2) mesh and the port's without a mesh: VCF
    bytes, phased-BAM payload and sorted HP/PS tags equal."""
    jmesh, tmesh = _meshes((4, 2))
    bam, fa = str(tmp_path / "g.bam"), str(tmp_path / "g.fa")
    make_genome_workload(bam, fa, contigs=GENOME)
    cfg = preset("hifi-masseq").replace(threads=2)
    got = run(bam, fa, str(tmp_path / "tm"), cfg, batched=True, device=CPU,
              mesh=tmesh)
    plain = run(bam, fa, str(tmp_path / "tp"), cfg, batched=True, device=CPU)
    want = jax_run(bam, fa, str(tmp_path / "jm"),
                   jax_preset("hifi-masseq").replace(threads=2),
                   batched=True, mesh=jmesh)
    st, pst = got.stage_seconds, plain.stage_seconds
    assert st["phase_buckets"] == pst["phase_buckets"] >= 2
    # without a mesh the router placed every bucket; with one, none
    assert (st["phase_host_placed"] + st["phase_card_placed"]
            == pst["phase_host_placed"] + pst["phase_card_placed"]
            - pst["phase_buckets"] - pst.get("phase_enum_buckets", 0))
    outs = []
    for o in (got, plain, want):
        with open(o.vcf_path, "rb") as f:
            vcf = f.read()
        outs.append((vcf, bytes(decompress_file(o.phased_bam_path)),
                     goldens.records_and_tags(o.vcf_path,
                                              o.phased_bam_path)[1]))
    assert outs[0] == outs[1] == outs[2]
    assert got.n_phased_sites == want.n_phased_sites > 0
    assert len(outs[0][2]) > 0


# --- the public functions no path calls ----------------------------------------

def _region(rng, K=48, I=24):
    p = rng.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = rng.integers(10, 31, size=(K, I)).astype(np.uint8)
    return (p, q, rng.choice([-1.0, 1.0], K), rng.choice([-1.0, 1.0], I),
            rng.choice([-1.0, 0.0, 1.0], I), rng.random(K) < 0.9,
            rng.random(I) < 0.9)


def test_phase_score_q_matches_jax(rng):
    p, q, sigma, _, _, rb, _ = _region(rng)
    col = np.zeros(p.shape, bool)
    col[:, 5] = True
    col[::3, 6] = True
    for delta_i in (1.0, -1.0):
        want = float(JK.phase_score_q(JK.make_cell_tables(p, q),
                                      jnp.asarray(sigma), delta_i,
                                      jnp.asarray(rb), jnp.asarray(col)))
        got = TK.phase_score_q(TK.as_tables(TK.CompactCells.from_numpy(p, q)),
                               _t(sigma), delta_i, _t(rb), _t(col))
        assert got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("with_genotype,keep_conserved",
                         [(True, False), (False, True)])
def test_cross_optimize_fast_matches_jax(rng, with_genotype, keep_conserved):
    p, q, sigma, delta, eta, rb, sm = _region(rng)
    cons = rng.random(sm.shape[0]) < 0.2
    want_st, want_p = JO.cross_optimize_fast(
        JK.make_cell_tables(p, q), JO.PhaseState(
            jnp.asarray(sigma), jnp.asarray(delta), jnp.asarray(eta)),
        jnp.asarray(rb), jnp.asarray(sm), jnp.asarray(cons), with_genotype,
        keep_conserved)
    got_st, got_p = TO.cross_optimize_fast(
        TK.CompactCells.from_numpy(p, q), TO.PhaseState(
            _t(sigma), _t(delta), _t(eta)), _t(rb), _t(sm), _t(cons),
        with_genotype, keep_conserved)
    for a, b in zip(got_st, want_st):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(float(got_p), float(want_p), rtol=RTOL)


def test_f64_decision_margin_matches_jax_and_the_fast_form(rng):
    """The reference form against the JAX package's, and the port's fast
    form (what the safety net runs) against the port's reference form, as
    tests/test_kernels_fast.py holds the JAX package's pair."""
    p, q, sigma, delta, eta, rb, sm = _region(rng)
    want = float(JO.f64_decision_margin(
        JK.make_cell_tables(p, q), JO.PhaseState(
            jnp.asarray(sigma), jnp.asarray(delta), jnp.asarray(eta)),
        jnp.asarray(rb), jnp.asarray(sm)))
    st = TO.PhaseState(_t(sigma), _t(delta), _t(eta))
    ref = TO.f64_decision_margin(TK.CompactCells.from_numpy(p, q), st,
                                 _t(rb), _t(sm))
    fast = TO.f64_decision_margin_fast(_t(p), _t(q), *st, _t(rb), _t(sm))
    assert np.isfinite(want)
    np.testing.assert_allclose(float(ref), want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(float(fast), float(ref), rtol=1e-9, atol=0)
