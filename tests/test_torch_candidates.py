"""Candidate kernel of the torch port vs the JAX package on simulated
pileups.

Tolerances: integers, masks and categories equal; f32 fields (allele
frequencies) equal; f64 fields (QUAL, GQ, genotype probabilities) within
1e-12 relative — the two implementations' f64 pow/log10 may differ by an
ulp.
"""

import jax
import numpy as np
import pytest
import torch

from longcallr_tpu.config import preset
from longcallr_tpu.io.bam import BamFile
from longcallr_tpu.ops import candidates as JC
from longcallr_tpu.tiles.pileup import build_pileup
from longcallr_tpu.tiles.regions import Region
from longcallr_tpu_torch.ops import candidates as TC
from simulate import make_reference, plant_snps, simulate_bam

F64_RTOL = 1e-12


def _pileup(tmp_path, seed, name, err_rate=0.03):
    rng = np.random.default_rng(seed)
    ref = make_reference(rng, 6000)
    truth = plant_snps(rng, ref, n_het=8, n_hom=2, min_gap=300)
    site = 3000
    planted = list(truth.het_snps) + list(truth.hom_snps)
    while any(abs(site - q) < 100 for q in planted):
        site += 37
    alt = int(b"ACGT"[(b"ACGT".index(bytes([int(ref[site])])) + 2) % 4])
    bam = str(tmp_path / f"c{seed}.bam")
    simulate_bam(bam, rng, ref, truth, n_reads=70, read_len=2000,
                 err_rate=err_rate, biased_sites={site: alt})
    cfg = preset(name)
    region = Region(chr="chrS", start=1, end=len(ref) + 1)
    return build_pileup(BamFile(bam), region, ref, cfg), cfg


def _compare(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        assert g.dtype == w.dtype, k
        if w.dtype == np.float64:
            np.testing.assert_allclose(g, w, rtol=F64_RTOL, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("strand_bias", [False, True])
@pytest.mark.parametrize("name,seed", [("ont-cdna", 11), ("hifi-masseq", 12),
                                       ("hifi-isoseq", 13)])
def test_candidate_kernel_matches_jax(tmp_path, name, seed, strand_bias):
    pl, cfg = _pileup(tmp_path, seed, name)
    cfg = cfg.replace(strand_bias=strand_bias)
    cols = JC._pad_cols(JC._kernel_cols(pl, None), JC._round_up(pl.length))
    want = jax.device_get(JC.candidate_kernel(cols, cfg))
    got = TC.candidate_kernel(TC._to_device(cols, torch.device("cpu")), cfg)
    got = {k: v.numpy() for k, v in got.items()}
    _compare(got, want)
    assert (got["category"] > 0).sum() > 0


@pytest.mark.parametrize("with_exon_mask", [False, True])
def test_select_candidates_matches_jax(tmp_path, with_exon_mask):
    """The full CandidateSet (kernel + host gather + dense-window passes)."""
    pl, cfg = _pileup(tmp_path, 21, "ont-cdna")
    em = None
    if with_exon_mask:
        em = np.zeros(pl.length, bool)
        em[500:4500] = True
    want = JC.select_candidates(pl, cfg, exon_mask=em)
    got = TC.select_candidates(pl, cfg, exon_mask=em,
                               device=torch.device("cpu"))
    assert got.n == want.n > 0
    for f in want.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if f == "chrom":
            assert a == b
        elif np.asarray(b).dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=F64_RTOL, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("strict", [True, False])
def test_dense_mask_matches_jax(strict):
    r = np.random.default_rng(3)
    pos = np.sort(r.choice(2000, size=300, replace=False))
    np.testing.assert_array_equal(TC.dense_mask(pos, 20, 4, strict),
                                  JC.dense_mask(pos, 20, 4, strict))
