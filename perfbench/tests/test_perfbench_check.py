"""Drives whole runs of the harness past its look for a card, on the CPU
at a small layout of each cell's traffic (the program's ``--platform cpu``
path): a sound program comes out correct, and each fault that a cell can
have, planted under the timed path, comes out not correct."""

import pytest

from conftest import SMALL_TRAFFIC
from harness import cell, check, manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2**33 + 5


@pytest.fixture
def small(monkeypatch, tmp_path):
    monkeypatch.setattr(manifest, "traffic", lambda name: SMALL_TRAFFIC[name])
    # every region of the small layouts is in the sample
    monkeypatch.setattr(cell, "SAMPLE_REGIONS", 16)

    def run(workload):
        return cell.run(workload, SEED, 0.5, False, platform="cpu",
                        workdir=str(tmp_path / "work"))
    return run


@pytest.mark.parametrize("workload", CELLS)
def test_sound_program_is_correct(small, workload):
    r = small(workload)
    assert r["correct"] is True
    assert all(v["value"] == 0 and v["limit"] == 0 for v in r["check"].values())
    assert set(r["check"]) == set(check.LIMITS)
    assert r["attempted"] >= 1 and r["metrics"]["reads_per_s"]["value"] > 0
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_where_produced(small, monkeypatch, workload):
    """One read's haplotype flipped in every region as it is assigned."""
    from longcallr_tpu_torch.pipeline import caller

    orig = caller.finalize_region

    def flipped(*a, **kw):
        res = orig(*a, **kw)
        for q, hp in sorted(res.read_assignments.items()):
            if hp:
                res.read_assignments[q] = 3 - hp
                break
        return res

    monkeypatch.setattr(caller, "finalize_region", flipped)
    r = small(workload)
    assert r["correct"] is False and r["check"]["tag_diffs"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_regions_left_out(small, monkeypatch, workload):
    """Every second region of the input dropped before it is called."""
    from longcallr_tpu_torch.pipeline import caller

    orig = caller.extract_isolated_regions_parallel
    monkeypatch.setattr(caller, "extract_isolated_regions_parallel",
                        lambda *a, **kw: orig(*a, **kw)[::2])
    r = small(workload)
    assert r["correct"] is False
    assert r["check"]["record_diffs"]["value"] > 0
    assert r["check"]["tag_diffs"]["value"] > 0


def test_a_pass_that_differs_is_caught(small, monkeypatch):
    """The last of two passes writes other records than the first."""
    from longcallr_tpu_torch.pipeline import caller

    orig = caller.finalize_region
    seen = []

    def later_differs(*a, **kw):
        res = orig(*a, **kw)
        seen.append(1)
        if len(seen) > 10 and res.vcf_lines:
            res.vcf_lines = res.vcf_lines[1:]
        return res

    monkeypatch.setattr(caller, "finalize_region", later_differs)
    r = cell.run("masseq-transcriptome", SEED, 1.0, False, platform="cpu",
                 workdir=None)
    assert r["correct"] is False and r["check"]["pass_diffs"]["value"] > 0


def test_an_earlier_pass_with_other_tags_is_caught(small, monkeypatch):
    """The first pass of the window assigns one read to the other
    haplotype; the last pass, which the reference judges, is sound."""
    from longcallr_tpu_torch import cli
    from longcallr_tpu_torch.pipeline import caller

    calls = []
    orig_main, orig_final = cli.main, caller.finalize_region

    def counted(argv):
        calls.append(1)
        return orig_main(argv)

    def flipped(*a, **kw):
        res = orig_final(*a, **kw)
        if len(calls) == 2:                 # the warm-up is the first call
            for q, hp in sorted(res.read_assignments.items()):
                if hp:
                    res.read_assignments[q] = 3 - hp
                    break
        return res

    monkeypatch.setattr(cli, "main", counted)
    monkeypatch.setattr(caller, "finalize_region", flipped)
    r = cell.run("masseq-transcriptome", SEED, 1.0, False, platform="cpu",
                 workdir=None)
    assert r["attempted"] >= 2
    assert r["correct"] is False and r["check"]["pass_diffs"]["value"] > 0


def test_the_sample_holds_every_class_of_size():
    regions = list(range(40))
    sizes = [(2 ** (3 + i % 5), 1000 * 2 ** (i % 3)) for i in regions]
    for seed in (1, 2**31 + 7):
        picked = check.sample(regions, sizes, seed, 8)
        classes = {(check._bucket(sizes[i][0]), check._bucket(sizes[i][1]))
                   for i in picked}
        assert len(classes) == 15 and len(picked) == 15
    assert len(check.sample(regions[:6], [(1, 1)] * 6, 3, 8)) == 6
    assert len(check.sample(regions, [(1, 1)] * 40, 3, 8)) == 8
