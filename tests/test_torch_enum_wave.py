"""A card wave's enumeration regions as one stream of float64 programs.

``phasing/enum_wave.phase_enum_wave`` phases a wave's enumeration regions
with the per-region float64 ascent program of each region's shape, chunk by
chunk of its configurations, the keep-best (``phasing/cuda_keep_best``) as
the program's last piece, every configuration's entry σ drawn on the host
from the region's numpy Generator, and one host read for the whole wave. On
the CPU the plain executor walks the same programs: the states must be
those of ``optimize.phase_region_on(..., split=False)`` and of the JAX
package's per-region float64 phase byte for byte, also where a region's
configurations span several chunks. The router
(``utils/device.phase_placement``) sends every enumeration problem of a card
run there; iterative problems, CPU runs, regions meshes and forced split
mode route as before. Loci simulated by ``utils/simulate.py`` (2 to 7
heterozygous SNPs, K buckets 64 to 256, two of a shape where a bucket
should form). No card is present here: a ``torch.device("cuda")`` is only
compared, and a stand-in runs the wave of a "card" run on the CPU.

The tests marked ``card`` skip where there is no CUDA card; on the card
(no JAX there; this file imports the JAX package only inside a CPU test):

    python -m pytest tests/test_torch_enum_wave.py -q -m card --noconftest

Tolerance: equality.
"""

import copy
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.io.fasta import FastaFile
from longcallr_tpu_torch.parallel import mesh as TM
from longcallr_tpu_torch.phasing import batch_driver as TBD
from longcallr_tpu_torch.phasing import cuda_keep_best as KB
from longcallr_tpu_torch.phasing import enum_wave as EW
from longcallr_tpu_torch.phasing import graphs
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.phasing.kernels import TIE_TOL
from longcallr_tpu_torch.pipeline.engine import STAGE_TOTALS, prepare_region
from longcallr_tpu_torch.tiles.regions import extract_isolated_regions_parallel
from longcallr_tpu_torch.utils import device as D
from longcallr_tpu_torch.utils import simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CARD = torch.device("cuda", 0)          # a name only on the CPU

# (heterozygous SNPs, reads): one locus each, every read across all of it;
# two loci of (K bucket 64, 2 SNPs) and two of (256, 4) form buckets
CASES = [(2, 40), (2, 45), (3, 120), (4, 250), (4, 240), (5, 70), (7, 60)]


@pytest.fixture(scope="module")
def loci(tmp_path_factory):
    """CASES as prepared regions: [(frags, cands, seed, apply_ds)]."""
    d = tmp_path_factory.mktemp("enum_wave")
    cfg = preset("hifi-masseq")
    out = []
    for n_het, n_reads in CASES:
        rng = np.random.default_rng([n_het, n_reads, 20])
        ref = simulate.make_reference(rng, 2_400)
        truth = simulate.plant_snps(rng, ref, n_het=n_het, n_hom=0, lo=400,
                                    hi=2_000, min_gap=150)
        bam_p = str(d / f"l{n_het}_{n_reads}.bam")
        simulate.simulate_bam(bam_p, rng, ref, truth, n_reads=n_reads,
                              read_len=3_000)
        bam, fasta = BamFile(bam_p), FastaFile(bam_p.replace(".bam", ".fa"))
        reg = max(extract_isolated_regions_parallel(
            bam, fasta.contig_lengths, cfg), key=lambda r: r.length)
        cands, frags, apply_ds = prepare_region(bam, reg, fasta.fetch("chrS"),
                                                cfg, CPU)
        assert frags.p.shape[1] == n_het <= cfg.max_enum_snps
        out.append((frags, cands, reg.start + n_reads, apply_ds))
    return cfg, out


def _equal(got, want, what) -> None:
    for name, a, b in zip(("sigma", "delta", "eta"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert a.tobytes() == b.tobytes(), (what, name)


# --- the wave against the per-region float64 path ---------------------------

@pytest.mark.parametrize("cells", [TO.ENUM_CHUNK_CELLS, 1 << 11],
                         ids=["one_chunk", "chunks"])
def test_wave_equals_the_per_region_f64_path(loci, monkeypatch, cells):
    """Every region's state from one wave equals phase_region_on's in
    float64, the wave mixing K buckets, candidate counts and shapes that
    occur once; with 2^11 cells a chunk, most regions' configurations span
    several chunks, so the keep-best carries its running best across
    programs."""
    cfg, items = loci
    monkeypatch.setattr(TO, "ENUM_CHUNK_CELLS", cells)
    chunks = [-(-(1 << f.p.shape[1]) // TO.enum_chunk(
        1 << f.p.shape[1], TO._bucket(f.p.shape[0]) * TO._bucket(
            f.p.shape[1]))) for f, *_ in items]
    many = sum(n > 1 for n in chunks)
    assert many == 0 if cells == 1 << 24 else many >= len(items) // 2
    got = EW.phase_enum_wave(items, cfg, CPU)
    assert len(got) == len(items)
    for i, ((frags, cands, seed, ds), st) in enumerate(zip(items, got)):
        _equal(st, TO.phase_region_on(frags, cands, cfg, seed, ds, CPU,
                                      False), i)


@pytest.fixture(scope="module", params=[TO.ENUM_CHUNK_CELLS, 1 << 11],
                ids=["one_chunk", "chunks"])
def wave_states(loci, request):
    """(cells a chunk, the loci's states from one wave at that size)."""
    cfg, items = loci
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TO, "ENUM_CHUNK_CELLS", request.param)
        return request.param, EW.phase_enum_wave(items, cfg, CPU)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_wave_equals_the_jax_packages_per_region_phase(loci, wave_states, i):
    """Region i's state from the wave equals the JAX package's per-region
    phase() of the same (frags, cands, seed) on the CPU (float64), byte for
    byte: an error shared by the port's per-region path and the wave would
    show here."""
    from longcallr_tpu.phasing import optimize as JO

    cfg, items = loci
    frags, cands, seed, ds = items[i]
    want = JO.phase_region(frags, cands, cfg, seed, ds)
    _equal(wave_states[1][i], tuple(np.asarray(a) for a in want),
           (wave_states[0], i))


def test_wave_counts_one_sync_and_its_regions(loci):
    cfg, items = loci
    before = dict(STAGE_TOTALS)
    EW.phase_enum_wave(items, cfg, CPU)
    assert STAGE_TOTALS["phase_enum_wave_syncs"] \
        == before.get("phase_enum_wave_syncs", 0) + 1
    assert STAGE_TOTALS["phase_enum_wave_regions"] \
        == before.get("phase_enum_wave_regions", 0) + len(items)


# --- the keep-best -----------------------------------------------------------

def _host_rule(probs, prev):
    """The host loop of optimize's enumeration leg."""
    best, sel = prev, -1
    for j in range(len(probs)):
        if probs[j] > best + TIE_TOL:
            best, sel = float(probs[j]), j
    return best, sel


_T = TIE_TOL
KEEP_CASES = {
    "ties_inside": ([-5.0, -5.0 + _T / 2, -5.0, -4.0, -4.0 - _T / 3], -np.inf),
    "at_the_tolerance": ([-5.0, -5.0 + _T, -5.0 + 2 * _T, -5.0 + 2.5 * _T],
                         -np.inf),
    "just_above": ([-5.0, -5.0 + _T * 1.0001, -5.0 + _T * 2.0003], -np.inf),
    "none_beats_prev": ([-7.0, -6.0, -6.0 + _T / 2], -6.0),
    "chained_prev": ([-6.0 + _T / 2, -6.0 + _T * 1.5, -3.0, -3.0], -6.0),
    "one": ([-2.5], -np.inf),
}


@pytest.mark.parametrize("case", sorted(KEEP_CASES))
def test_keep_best_plain_equals_the_host_rule(case):
    probs, prev = KEEP_CASES[case]
    p = torch.tensor(probs, dtype=torch.float64)
    v = torch.tensor(prev, dtype=torch.float64)
    best, sel = KB.keep_best_plain(p, v, TIE_TOL)
    want_best, want_sel = _host_rule(np.asarray(probs), prev)
    assert (float(best), int(sel)) == (want_best, want_sel)
    out = (torch.empty((), dtype=torch.float64),
           torch.empty((), dtype=torch.int64))
    assert KB.keep_best(p, v, TIE_TOL, out=out) == out
    assert (float(out[0]), int(out[1])) == (want_best, want_sel)


# --- routing -----------------------------------------------------------------

@pytest.mark.parametrize("work", [1 << 13, 1 << 23])
def test_card_enumeration_problems_run_in_float64(work):
    """2^13 and 2^23 are the ends of the sweep's enumeration sizes."""
    assert D.phase_placement(work, CARD, enumeration=True) \
        == D.Placement(CARD, True)


@pytest.mark.parametrize("case", ["iterative", "cpu_run", "forced_split"])
def test_other_problems_route_as_before(monkeypatch, case):
    t, P = D.MIN_ACCEL_PHASE_WORK, D.Placement
    if case == "iterative":
        assert D.phase_placement(t - 1, CARD) == P(CPU, False)
        assert D.phase_placement(t, CARD) == P(CARD, False)
    elif case == "cpu_run":
        for enum in (False, True):
            assert D.phase_placement(1, CPU, enum) == P(CPU, False)
            assert D.phase_placement(1 << 40, CPU, enum) == P(CPU, False)
    else:
        monkeypatch.setattr(TO, "USE_F32_KERNELS", True)
        assert D.phase_placement(t - 1, CARD, True) == P(CARD, True)
        assert TO.placed_split(P(CARD, True)) is True
        assert D.phase_placement(t, CARD, True) == P(CARD, False)


class _BucketPath(Exception):
    """The split bucket path was reached (its bucket's upload)."""


def _wave_stand_in(monkeypatch):
    """Runs a "card" run's wave on the CPU: the calls' regions, one list a
    wave."""
    calls, orig = [], TBD.phase_enum_wave

    def wave(items, cfg, device):
        assert device == CARD
        calls.append([it[0].p.shape for it in items])
        return orig(items, cfg, CPU)

    monkeypatch.setattr(TBD, "phase_enum_wave", wave)
    return calls


def test_a_card_run_phases_its_enumeration_regions_in_one_wave(
        loci, monkeypatch):
    """Lone regions and bucket members alike go to one wave, one router
    call a problem, with the CPU run's states and no bucket program."""
    cfg, items = loci
    want = TBD.phase_regions_batched(items, cfg, device=CPU)
    calls = _wave_stand_in(monkeypatch)
    monkeypatch.setattr(TBD, "_bucket_on", lambda *a: (_ for _ in ()).throw(
        _BucketPath()))
    placed = dict(D.PLACEMENTS)
    buckets = STAGE_TOTALS.get("phase_enum_buckets", 0)
    got = TBD.phase_regions_batched(items, cfg, device=CARD)
    for i, (a, b) in enumerate(zip(got, want)):
        _equal(a, b, i)
    assert len(calls) == 1 and len(calls[0]) == len(items)
    shapes = {(TO._bucket(f.p.shape[0]), f.p.shape[1]) for f, *_ in items}
    assert D.PLACEMENTS["card_f64"] - placed["card_f64"] == len(shapes)
    assert D.PLACEMENTS["card"] == placed["card"]
    assert STAGE_TOTALS.get("phase_enum_buckets", 0) == buckets


@pytest.mark.parametrize("case", ["forced_split", "mesh", "cpu_run"])
def test_the_wave_is_bypassed(loci, monkeypatch, case):
    """Forced split mode keeps the split bucket path for a bucket of card
    size (reached here at its upload); a regions mesh and a CPU run make
    no wave."""
    cfg, items = loci
    calls = _wave_stand_in(monkeypatch)
    if case == "forced_split":
        monkeypatch.setattr(TO, "USE_F32_KERNELS", True)
        monkeypatch.setattr(D, "MIN_ACCEL_PHASE_WORK", 0)
        monkeypatch.setattr(TBD, "_bucket_on", lambda *a: (
            _ for _ in ()).throw(_BucketPath()))
        with pytest.raises(_BucketPath):
            TBD.phase_regions_batched(items[:2], cfg, device=CARD)
    elif case == "mesh":
        mesh = TM.make_mesh(2, 1, [CPU, CPU])
        got = TBD.phase_regions_batched(items, cfg, device=CPU, mesh=mesh)
        for i, (a, (f, c, s, ds)) in enumerate(zip(got, items)):
            _equal(a, TO.phase_region_on(f, c, cfg, s, ds, CPU, False), i)
    else:
        TBD.phase_regions_batched(items, cfg, device=CPU)
    assert calls == []


# --- the deferred census -----------------------------------------------------

def test_a_census_that_disagrees_with_the_body_runs_raises():
    """``Program.account``, which a wave calls for each launch after its
    one sync, raises where the set-condition launches disagree with the
    loop's body runs."""
    flag = torch.zeros((), dtype=torch.bool)
    prog = graphs.Program(CPU, {}, (graphs.While(flag, (graphs.Piece(
        "body", lambda: None),)),), ())
    with pytest.raises(RuntimeError, match="set-condition"):
        prog.account([3, 3])                # 3 runs make 4 launches


# --- the benchmark's reader ----------------------------------------------------

def test_the_benchmark_reads_the_wave_syncs():
    spec = importlib.util.spec_from_file_location(
        "enum_wave_syncs", os.path.join(REPO, "perfbench", "metrics",
                                        "phase.enum_wave_syncs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    p = lambda stage: types.SimpleNamespace(stage=stage)
    ctx = {"passes": [p({"phase_enum_wave_syncs": 14.0}),
                      p({"phase_enum_wave_syncs": 15.0})]}
    assert mod.read(ctx) == 14.5
    assert mod.read({"passes": [p({"phase_card_f64_placed": 176.0})]}) is None


# --- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    """Skips the test where this machine has no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.card
def test_keep_best_kernel_equals_its_plain_version(card):
    rng = np.random.default_rng(7)
    for C in (1, 2, 63, 1024, 4099):
        base = np.round(rng.normal(-40.0, 3.0, C), 1)
        # ties inside, at and just above the tolerance
        base[rng.integers(0, C, C // 3)] += rng.choice(
            [0.0, TIE_TOL / 2, TIE_TOL, TIE_TOL * 1.0001], C // 3)
        for prev in (-np.inf, float(np.median(base))):
            p = torch.tensor(base, dtype=torch.float64)
            v = torch.tensor(prev, dtype=torch.float64)
            want = KB.keep_best_plain(p, v, TIE_TOL)
            got = KB.keep_best(p.to(card), v.to(card), TIE_TOL)
            torch.cuda.synchronize()
            assert torch.equal(got[0].cpu(), want[0]), (C, prev)
            assert torch.equal(got[1].cpu(), want[1]), (C, prev)


@pytest.mark.card
@pytest.mark.parametrize("cells", [TO.ENUM_CHUNK_CELLS, 1 << 11],
                         ids=["one_chunk", "chunks"])
def test_the_wave_on_the_card_equals_the_per_region_f64_path(
        loci, card, monkeypatch, cells):
    """As on the CPU, on the card's device programs: with 2^11 cells a
    chunk the wave launches more programs than a block of counter rows
    holds, and the keep-best carries its running best across them."""
    cfg, items = loci
    monkeypatch.setattr(TO, "ENUM_CHUNK_CELLS", cells)
    syncs = STAGE_TOTALS.get("phase_enum_wave_syncs", 0)
    got = EW.phase_enum_wave(items, cfg, card)
    assert STAGE_TOTALS["phase_enum_wave_syncs"] == syncs + 1
    launches = sum(-(-(1 << f.p.shape[1]) // TO.enum_chunk(
        1 << f.p.shape[1], TO._bucket(f.p.shape[0]) * TO._bucket(
            f.p.shape[1]))) for f, *_ in items)
    assert launches > graphs.Launches.ROWS or cells != 1 << 11
    for i, ((frags, cands, seed, ds), st) in enumerate(zip(items, got)):
        _equal(st, TO.phase_region_on(frags, cands, cfg, seed, ds, card,
                                      False), i)
    graphs.free_all()


@pytest.mark.card
def test_a_planted_census_mismatch_raises_after_the_sync(loci, card,
                                                         monkeypatch):
    """A wave whose launch's set-condition count is raised by one on the
    card, after the launch, raises at its one read, and leaves no launch
    pending."""
    cfg, items = loci
    real = graphs.Program.enqueue

    def planted(self, into):
        real(self, into)
        into[-1][-1:].add_(1)           # one set-condition launch too many

    monkeypatch.setattr(graphs.Program, "enqueue", planted)
    with pytest.raises(RuntimeError, match="set-condition"):
        EW.phase_enum_wave(items[:1], cfg, card)
    assert all(s.pending == 0 for s in graphs._CACHE.values())
    graphs.free_all()


@pytest.mark.card
def test_the_cells_input_phases_as_per_region_f64(card, tmp_path,
                                                  monkeypatch):
    """The benchmark cell's input (``perfbench``'s masseq-transcriptome
    traffic): every region a wave phased has the state of
    ``phase_region_f64`` on the card, each wave reads once, and nothing is
    rerun."""
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.pipeline.caller import run

    with open(os.path.join(REPO, "perfbench", "traffic",
                           "transcriptome.json")) as f:
        spec = json.load(f)
    gen = subprocess.run([sys.executable, os.path.join(
        REPO, "perfbench", "harness", "generate.py"), json.dumps(spec),
        "2147483725", str(tmp_path)], capture_output=True, text=True)
    assert gen.returncode == 0, gen.stderr[-4000:]
    waves, orig = [], TBD.phase_enum_wave

    def wave(items, cfg, device):
        # the finalize updates a region's fragments and candidates in place
        # (phasing/assign.py): compare on the wave's own inputs
        waves.append((copy.deepcopy(items), orig(items, cfg, device)))
        return waves[-1][1]

    monkeypatch.setattr(TBD, "phase_enum_wave", wave)
    flag_reads = CK.GRAPHS["flag_reads"]
    cfg = dataclasses.replace(preset("hifi-masseq"), threads=8)
    out = run(str(tmp_path / "in.bam"), str(tmp_path / "in.fa"),
              str(tmp_path / "out"), cfg, device=card)
    st = out.stage_seconds
    assert st["phase_enum_wave_syncs"] == len(waves) >= 10
    assert st["phase_enum_wave_regions"] == sum(len(i) for i, _ in waves) \
        > 0
    assert st["phase_safety_recompute"] == out.n_f64_reruns == 0
    assert CK.GRAPHS["flag_reads"] == flag_reads
    for w, (items, states) in enumerate(waves):
        for i, ((frags, cands, seed, ds), s) in enumerate(zip(items, states)):
            _equal(s, TO.phase_region_f64(frags, cands, cfg, seed, ds, card),
                   (w, i))
