"""The torch port's placement by size (``utils/device.py``) on the CPU.

Counterparts of ``tests/test_kernels_fast.py::test_phase_work_routing`` and
``::test_degraded_placement_surfaced`` with explicit devices, the work each
call site hands the router (held against the JAX package's own router calls
on the same regions), and outputs that do not depend on the placement:
bytes equal with the router at its default, forced off (threshold 0) and
forced all-host (threshold 2^62). No card is present here, so a
``torch.device("cuda")`` is only ever compared, never allocated on.
Tolerance: equality.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from longcallr_tpu.config import preset as jax_preset
from longcallr_tpu.phasing import batch_driver as JBD
from longcallr_tpu.phasing import optimize as JO
from longcallr_tpu_torch import cli
from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.io.fasta import FastaFile
from longcallr_tpu_torch.ops import candidates as TC
from longcallr_tpu_torch.phasing import batch_driver as TBD
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.pipeline.caller import run
from longcallr_tpu_torch.pipeline.engine import prepare_region
from longcallr_tpu_torch.tiles.regions import extract_isolated_regions_parallel
from longcallr_tpu_torch.utils import device as D
from longcallr_tpu_torch.utils import goldens
from longcallr_tpu_torch.utils.bench_workload import make_genome_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CARD = torch.device("cuda", 0)          # a name only: nothing is put on it
ALL_HOST = 1 << 62

# loci of 4 SNPs (enumeration) and of 13-24 SNPs (iterative), two of a kind
# each so that both kinds of bucket form
LOCI = [("chrA", [(4_000, 40, 900), (4_000, 40, 900), (6_000, 30, 250)]),
        ("chrB", [(6_000, 30, 250), (5_000, 25, 400)])]


@pytest.fixture
def thresholds(monkeypatch):
    monkeypatch.setattr(D, "MIN_ACCEL_PHASE_WORK", 1 << 23)
    monkeypatch.setattr(D, "MIN_ACCEL_CELLS", 1 << 24)


def test_phase_work_routing(thresholds):
    """Below the threshold the host, at it the run's device; a CPU run
    gets the CPU at every size."""
    t = D.MIN_ACCEL_PHASE_WORK
    assert D.phase_problem_device(t - 1, CARD) == CPU
    assert D.phase_problem_device(t, CARD) == CARD
    assert D.phase_problem_device(1 << 40, CARD) == CARD
    assert D.phase_problem_device(1, CPU) == CPU
    assert D.phase_problem_device(1 << 40, CPU) == CPU
    c = D.MIN_ACCEL_CELLS
    assert D.small_problem_device(c - 1, CARD) == CPU
    assert D.small_problem_device(c, CARD) == CARD
    assert D.small_problem_device(c, CPU) == CPU


@pytest.mark.parametrize("value,below,at", [(0, None, CARD),
                                            (ALL_HOST, CPU, CPU)])
def test_router_forced_off_and_all_host(monkeypatch, value, below, at):
    monkeypatch.setattr(D, "MIN_ACCEL_PHASE_WORK", value)
    monkeypatch.setattr(D, "MIN_ACCEL_CELLS", value)
    assert D.phase_problem_device(1 << 40, CARD) == at
    assert D.small_problem_device(1 << 40, CARD) == at
    assert D.phase_problem_device(0, CARD) == (below or CARD)
    assert D.small_problem_device(0, CARD) == (below or CARD)


def test_degraded_placement_surfaced(thresholds, caplog, monkeypatch):
    """A problem of card size on a CPU run is counted and warned of once; a
    problem below the threshold is on the host by design and not counted;
    on a card run nothing is degraded."""
    monkeypatch.setattr(D, "_warned_degraded", False)
    before = D.DEGRADED_PLACEMENTS
    placed = dict(D.PLACEMENTS)
    t = D.MIN_ACCEL_PHASE_WORK
    with caplog.at_level(logging.WARNING, logger="longcallr_tpu_torch"):
        assert D.phase_problem_device(t, CPU) == CPU
        assert D.phase_problem_device(2 * t, CPU) == CPU
    assert D.DEGRADED_PLACEMENTS == before + 2
    warned = [r.getMessage() for r in caplog.records
              if "run's device is the CPU" in r.getMessage()]
    assert len(warned) == 1                    # once per process
    assert "100x" not in warned[0]             # no other hardware's numbers
    D.phase_problem_device(1, CPU)
    D.phase_problem_device(1, CARD)
    D.phase_problem_device(t, CARD)
    assert D.DEGRADED_PLACEMENTS == before + 2
    assert D.PLACEMENTS["host"] == placed["host"] + 4
    assert D.PLACEMENTS["card"] == placed["card"] + 1


def test_resolve_device_still_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-b", "x.bam", "-f", "x.fa", "-o", "x", "-p", "hifi-masseq",
                  "--platform", "cuda"])


@pytest.mark.parametrize("env,want", [({}, None), (
    {"LONGCALLR_TPU_MIN_PHASE_WORK": "12345", "LONGCALLR_TPU_MIN_CELLS": "77"},
    (12345, 77))])
def test_thresholds_come_from_the_environment(env, want):
    """The JAX package's variable names set the port's thresholds; without
    them the defaults are the measured ones."""
    code = ("from longcallr_tpu_torch.utils import device as D; "
            "print(D.MIN_ACCEL_PHASE_WORK, D.MIN_ACCEL_CELLS)")
    clean = {k: v for k, v in os.environ.items()
             if not k.startswith("LONGCALLR_TPU_MIN_")}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(clean, **env), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    got = tuple(int(x) for x in res.stdout.split())
    if want is not None:
        assert got == want
    elif len(clean) == len(os.environ):     # this process had none set
        assert got == (D.MIN_ACCEL_PHASE_WORK, D.MIN_ACCEL_CELLS)


# --- the work each call site hands the router --------------------------------

@pytest.fixture(scope="module")
def regions(tmp_path_factory):
    """Prepared regions of LOCI through each package's own stages:
    [(torch item, jax item)] with item = (frags, cands, seed, apply_ds)."""
    from longcallr_tpu.io.bam import BamFile as JBam
    from longcallr_tpu.pipeline.engine import prepare_region as jprepare
    from longcallr_tpu.tiles.regions import \
        extract_isolated_regions_parallel as jextract

    d = tmp_path_factory.mktemp("placement")
    bam_p, fa_p = str(d / "p.bam"), str(d / "p.fa")
    make_genome_workload(bam_p, fa_p, contigs=LOCI)
    fasta = FastaFile(fa_p)
    cfg, jcfg = preset("hifi-masseq"), jax_preset("hifi-masseq")
    bam, jbam = BamFile(bam_p), JBam(bam_p)
    items = []
    for reg, jreg in zip(
            extract_isolated_regions_parallel(bam, fasta.contig_lengths, cfg),
            jextract(jbam, fasta.contig_lengths, jcfg)):
        ref = fasta.fetch(reg.chr)
        cands, frags, ds = prepare_region(bam, reg, ref, cfg, CPU)
        jc, jf, jds = jprepare(jbam, jreg, ref, jcfg)
        items.append(((frags, cands, reg.start, ds),
                      (jf, jc, jreg.start, jds)))
    assert len(items) == 5
    return items, cfg, jcfg, (bam_p, fa_p)


def _spy(monkeypatch, modules, name="phase_problem_device"):
    """Records the work of every router call made through ``modules``."""
    seen = []
    for mod in modules:
        orig = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda work, *a, _o=orig: seen.append(int(work))
            or _o(work, *a))
    return seen


def test_per_region_router_work_matches_the_jax_package(regions,
                                                        monkeypatch):
    """One router call per region, with 2^I0 · K · I_pad for an enumeration
    region and K · I_pad · (I0 // 4 + 1) otherwise: the numbers the JAX
    package hands its router for the same regions."""
    items, cfg, jcfg, _ = regions
    got = _spy(monkeypatch, [TO])
    want = _spy(monkeypatch, [JO])
    for (frags, cands, seed, ds), (jf, jc, jseed, jds) in items:
        a = TO.phase_region(frags, cands, cfg, seed, ds, device=CPU)
        b = JO.phase_region(jf, jc, jcfg, jseed, jds)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))
    assert got == want and len(got) == 5
    K0, I0 = items[0][0][0].p.shape
    assert I0 <= cfg.max_enum_snps
    assert got[0] == (1 << I0) * TO._bucket(K0) * TO._bucket(I0)
    K0, I0 = items[2][0][0].p.shape
    assert I0 > cfg.max_enum_snps
    assert got[2] == TO._bucket(K0) * TO._bucket(I0) * (I0 // 4 + 1)


def test_bucket_router_work_matches_the_jax_package(regions, monkeypatch):
    """One router call per bucket (and per region phased alone), with the
    JAX package's work for the same buckets."""
    items, cfg, jcfg, _ = regions
    got = _spy(monkeypatch, [TBD, TO])
    want = _spy(monkeypatch, [JBD, JO])
    a = TBD.phase_regions_batched([t for t, _ in items], cfg, device=CPU)
    b = JBD.phase_regions_batched([j for _, j in items], jcfg)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, np.asarray(v))
    assert sorted(got) == sorted(want) and len(got) >= 2


def test_bucket_below_the_threshold_goes_to_the_host(regions, monkeypatch):
    """A run on a card whose buckets are all below the threshold phases
    every member on the host (nothing is allocated on the card), one router
    call a bucket, with the states of the CPU run's buckets."""
    items, cfg, _, _ = regions
    want = TBD.phase_regions_batched([t for t, _ in items], cfg, device=CPU)
    monkeypatch.setattr(D, "MIN_ACCEL_PHASE_WORK", ALL_HOST)
    placed = dict(D.PLACEMENTS)
    calls = _spy(monkeypatch, [TBD, TO])
    got = TBD.phase_regions_batched([t for t, _ in items], cfg, device=CARD)
    for x, y in zip(got, want):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert D.PLACEMENTS["host"] - placed["host"] == len(calls) >= 2
    assert D.PLACEMENTS["card"] == placed["card"]


def test_candidate_cells_reach_the_router(regions, monkeypatch):
    """select_candidates(_batched) hand the router Ppad · 16 cells."""
    _, cfg, _, (bam_p, fa_p) = regions
    from longcallr_tpu_torch.pipeline.engine import prepare_region_pileup

    bam, fasta = BamFile(bam_p), FastaFile(fa_p)
    regs = extract_isolated_regions_parallel(bam, fasta.contig_lengths, cfg)
    pls = [prepare_region_pileup(bam, r, fasta.fetch(r.chr), cfg)
           for r in regs[:2]]
    seen = _spy(monkeypatch, [TC], "small_problem_device")
    one = TC.select_candidates(pls[0], cfg, device=CPU)
    assert seen == [TC._round_up(pls[0].length) * 16]
    both = TC.select_candidates_batched(pls, cfg, device=CPU)
    assert seen[1:] == [TC._round_up(pls[0].length + pls[1].length) * 16]
    np.testing.assert_array_equal(one.pos, both[0].pos)
    # all-host on a card run: the kernel runs on the CPU, same candidates
    monkeypatch.setattr(D, "MIN_ACCEL_CELLS", ALL_HOST)
    host = TC.select_candidates(pls[0], cfg, device=CARD)
    np.testing.assert_array_equal(one.pos, host.pos)
    np.testing.assert_array_equal(one.genotype, host.genotype)


# --- outputs do not depend on the placement ----------------------------------

@pytest.mark.parametrize("router", ["default", "off", "all_host"])
@pytest.mark.parametrize("name", goldens.GOLDEN_NAMES)
def test_preset_golden_with_the_router(tmp_path, monkeypatch, name, router):
    if router != "default":
        value = 0 if router == "off" else ALL_HOST
        monkeypatch.setattr(D, "MIN_ACCEL_PHASE_WORK", value)
        monkeypatch.setattr(D, "MIN_ACCEL_CELLS", value)
    bam, fa, cfg, anno = goldens.golden_workload(name, str(tmp_path))
    out = run(bam, fa, str(tmp_path / "out"), cfg, anno_path=anno,
              device=CPU)
    assert goldens.records_and_tags(out.vcf_path, out.phased_bam_path) \
        == goldens.golden(name)
    st = out.stage_seconds
    assert 0 < st["phase_host_placed"] <= out.n_regions
    assert st["phase_card_placed"] == 0
    if router == "all_host":
        assert out.n_degraded_placements == 0
    elif router == "off":
        assert out.n_degraded_placements == st["phase_host_placed"]


@pytest.mark.parametrize("router", ["off", "all_host"])
def test_cli_prints_the_placement_counts(regions, tmp_path, monkeypatch,
                                         capsys, router):
    _, _, _, (bam_p, fa_p) = regions
    value = 0 if router == "off" else ALL_HOST
    monkeypatch.setattr(D, "MIN_ACCEL_PHASE_WORK", value)
    rc = cli.main(["-b", bam_p, "-f", fa_p, "-o", str(tmp_path / router),
                   "-p", "hifi-masseq", "--platform", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    lines = {l.strip() for l in out.splitlines()}
    n = int(cli.LAST_RUN.stage_seconds["phase_host_placed"])
    assert n >= 2 and f"count phase_host_placed: {n}" in lines
    assert "count phase_card_placed: 0" in lines
    degraded = [l for l in lines if "of card size run on the host" in l]
    assert bool(degraded) == (router == "off")
    if degraded:
        assert degraded[0].endswith(f": {n}")
    with open(str(tmp_path / router) + ".vcf", "rb") as f:
        vcf = f.read()
    base = run(bam_p, fa_p, str(tmp_path / "base"), preset("hifi-masseq"),
               device=CPU)
    with open(base.vcf_path, "rb") as f:
        assert f.read() == vcf
