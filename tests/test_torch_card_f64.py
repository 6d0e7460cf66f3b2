"""Float64 on the card against float64 on the host, region by region.

A card run places an enumeration problem of little work in float64 on the
card (``utils/device.phase_placement``), where the host's float64 path ran
it before: the bytes must be the host's. Regions simulated by
``utils/simulate.py`` (2 to 9 heterozygous SNPs, K buckets 64 to 1024) are
prepared on the host and phased by ``optimize.phase_region_on`` with
``split=False`` on both devices; the programs that route builds, one per
shape, hold their buffers and no cuBLAS workspace each. The tests marked
``card`` skip where there is no CUDA card; on the card, where there is no
JAX:

    python -m pytest tests/test_torch_card_f64.py -q -m card --noconftest

This file imports neither JAX nor the JAX package. Tolerance: equality.
"""

import numpy as np
import pytest
import torch

from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.io.fasta import FastaFile
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.pipeline.engine import prepare_region
from longcallr_tpu_torch.tiles.regions import extract_isolated_regions_parallel
from longcallr_tpu_torch.utils import simulate

CPU = torch.device("cpu")

# (heterozygous SNPs, reads): one locus each, every read across all of it
CASES = [(2, 40), (3, 120), (4, 250), (5, 500), (6, 1000), (7, 60),
         (8, 300), (9, 900)]


@pytest.fixture(scope="module")
def loci(tmp_path_factory):
    """CASES as prepared regions: {case: (frags, cands, seed, apply_ds)}."""
    d = tmp_path_factory.mktemp("card_f64")
    cfg = preset("hifi-masseq")
    out = {}
    for n_het, n_reads in CASES:
        rng = np.random.default_rng([n_het, n_reads])
        ref = simulate.make_reference(rng, 2_400)
        truth = simulate.plant_snps(rng, ref, n_het=n_het, n_hom=0, lo=400,
                                    hi=2_000, min_gap=150)
        bam_p = str(d / f"l{n_het}_{n_reads}.bam")
        # the simulator writes the reference beside the BAM
        simulate.simulate_bam(bam_p, rng, ref, truth, n_reads=n_reads,
                              read_len=3_000)
        fa_p = bam_p.replace(".bam", ".fa")
        bam, fasta = BamFile(bam_p), FastaFile(fa_p)
        reg = max(extract_isolated_regions_parallel(
            bam, fasta.contig_lengths, cfg), key=lambda r: r.length)
        cands, frags, apply_ds = prepare_region(bam, reg, fasta.fetch("chrS"),
                                                cfg, CPU)
        out[(n_het, n_reads)] = (frags, cands, reg.start, apply_ds)
    return cfg, out


@pytest.fixture
def card():
    """Skips the test where this machine has no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("case", CASES)
def test_the_loci_are_small_enumeration_problems(loci, case):
    """Each locus is one enumeration region of its SNPs, in the K bucket
    its reads make, of less work than the router's threshold."""
    cfg, regions = loci
    frags, cands, _, _ = regions[case]
    K0, I0 = frags.p.shape
    assert I0 == case[0] <= cfg.max_enum_snps
    assert 64 <= TO._bucket(K0) <= 1024
    assert TO._bucket(K0) == TO._bucket(case[1])


@pytest.mark.card
def test_f64_on_the_card_equals_f64_on_the_host(loci, card):
    cfg, regions = loci
    for case, (frags, cands, seed, apply_ds) in regions.items():
        host = TO.phase_region_on(frags, cands, cfg, seed, apply_ds, CPU,
                                  False)
        on_card = TO.phase_region_on(frags, cands, cfg, seed, apply_ds, card,
                                     False)
        for name, a, b in zip(("sigma", "delta", "eta"), on_card, host):
            assert a.dtype == b.dtype and a.shape == b.shape, (case, name)
            assert a.tobytes() == b.tobytes(), (case, name)


@pytest.mark.card
def test_new_programs_leave_no_cublas_workspace_behind(loci, card):
    """Programs of new shapes built one after another hold little beside
    their buffers: every program of a card is captured on one stream, so
    cuBLAS keeps one workspace (32 MiB on an H100) for all of them, not
    one for each stream a capture took from the pool."""
    from longcallr_tpu_torch.phasing import graphs as G

    cfg, regions = loci
    G.free_all()
    G.reset_builds()
    try:
        for frags, cands, seed, apply_ds in regions.values():
            TO.phase_region_on(frags, cands, cfg, seed, apply_ds, card, False)
        held = [b["bytes_held"] for b in G.BUILDS]
    finally:
        G.free_all()
    assert len(held) >= len(CASES)          # a program per shape at least
    # the first capture may still take the stream's workspace
    assert sum(held[1:]) < 32 << 20, held
