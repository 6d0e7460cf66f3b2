"""The torch port's batched pipeline on the CPU, end to end.

The same simulated BAM goes through the port's batched run, the port's
per-region run and the JAX package's batched run (CPU backend). Tolerance:
equal VCF bytes and equal phased-BAM payloads (the two packages build their
deflate codec separately, so the compressed bytes may differ where the
payload is the same).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from longcallr_tpu.config import preset as jax_preset
from longcallr_tpu.pipeline.caller import run as jax_run
from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io.bgzf import decompress_file
from longcallr_tpu_torch.phasing import batch_driver as TBD
from longcallr_tpu_torch.pipeline import caller as TCALL
from longcallr_tpu_torch.pipeline.caller import run
from longcallr_tpu_torch.pipeline.engine import STAGE_COUNTS
from longcallr_tpu_torch.tiles.regions import Region
from longcallr_tpu_torch.utils import goldens
from longcallr_tpu_torch.utils.bench_workload import (make_deep_workload,
                                                      make_genome_workload)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# 3 contigs, 7 loci of mixed depth: iterative buckets of several shapes and
# enumeration-sized loci
GENOME = [("chrA", [(6000, 20, 160), (5000, 30, 200)]),
          ("chrB", [(6000, 60, 200), (4000, 25, 150)]),
          ("chrC", [(5000, 20, 160), (5000, 20, 1300), (4000, 40, 1500)])]


def _payloads(out):
    with open(out.vcf_path, "rb") as f:
        vcf = f.read()
    return vcf, bytes(decompress_file(out.phased_bam_path))


@pytest.fixture
def genome(tmp_path):
    bam, fa = str(tmp_path / "g.bam"), str(tmp_path / "g.fa")
    make_genome_workload(bam, fa, contigs=GENOME)
    return bam, fa


@pytest.fixture
def deep3(tmp_path):
    """Three deep loci on one contig, each its own region."""
    bam, fa = str(tmp_path / "wv.bam"), str(tmp_path / "wv.fa")
    make_deep_workload(bam, fa, n_regions=3, region_len=2400, snp_spacing=120,
                       coverage=30, read_len=600, err_rate=0.0, gap=3000,
                       seed=7, contig="chrW")
    return bam, fa


def test_batched_run_equals_per_region_run_and_jax_batched_run(genome,
                                                               tmp_path):
    bam, fa = genome
    cfg = preset("hifi-masseq").replace(threads=2)
    got = run(bam, fa, str(tmp_path / "tb"), cfg, batched=True, device=CPU)
    per = run(bam, fa, str(tmp_path / "tp"), cfg, batched=False, device=CPU)
    want = jax_run(bam, fa, str(tmp_path / "jb"),
                   jax_preset("hifi-masseq").replace(threads=2), batched=True)
    assert got.n_regions >= 3 and got.n_records > 0
    assert got.stage_seconds["phase_buckets"] >= 2
    assert "phase_buckets" not in per.stage_seconds or \
        per.stage_seconds["phase_buckets"] == 0
    a, b, c = _payloads(got), _payloads(per), _payloads(want)
    assert a[0] == b[0] == c[0]
    assert a[1] == b[1] == c[1]
    assert got.n_phased_sites == want.n_phased_sites > 0
    assert got.n_reads_tagged == want.n_reads_tagged > 0


@pytest.mark.parametrize("n_regions,batched", [(1, False), (3, True)])
def test_auto_resolves_by_region_count(tmp_path, n_regions, batched,
                                       monkeypatch):
    """batched=None: the batched pipeline for more than one region, the
    per-region loop for one."""
    bam, fa = str(tmp_path / "a.bam"), str(tmp_path / "a.fa")
    make_deep_workload(bam, fa, n_regions=n_regions, region_len=2400,
                       snp_spacing=120, coverage=30, read_len=600,
                       err_rate=0.0, gap=3000, seed=9, contig="chrW")
    calls = []
    orig = TCALL._run_batched
    monkeypatch.setattr(TCALL, "_run_batched",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    out = run(bam, fa, str(tmp_path / "auto"),
              preset("hifi-masseq").replace(min_read_length=100), device=CPU)
    assert out.n_regions == n_regions
    assert bool(calls) == batched
    assert ("phased_bam_bg" in out.stage_seconds) == batched


def _spy_waves(monkeypatch):
    calls = []
    orig = TBD.phase_regions_batched

    def spy(items, *a, **kw):
        calls.append(len(items))
        return orig(items, *a, **kw)

    monkeypatch.setattr(TBD, "phase_regions_batched", spy)
    return calls


@pytest.mark.parametrize("wave_overlap", ["1", "0"])
@pytest.mark.parametrize("write_overlap", ["1", "0"])
def test_wave_split_and_overlaps_byte_identical(deep3, tmp_path, monkeypatch,
                                                wave_overlap, write_overlap):
    """One region per wave (LONGCALLR_WAVE_CELLS=1), with the double-
    buffered prepare and the overlapped phased-BAM write each on and off:
    the bytes of the default one-wave run."""
    bam, fa = deep3
    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=2)
    calls = _spy_waves(monkeypatch)
    base = run(bam, fa, str(tmp_path / "one_wave"), cfg, batched=True,
               device=CPU)
    assert calls == [3]                      # default budget: one wave
    calls.clear()
    monkeypatch.setenv("LONGCALLR_WAVE_CELLS", "1")
    monkeypatch.setenv("LONGCALLR_WAVE_OVERLAP", wave_overlap)
    monkeypatch.setenv("LONGCALLR_RESIDENT_WRITE_OVERLAP", write_overlap)
    split = run(bam, fa, str(tmp_path / "split"), cfg, batched=True,
                device=CPU)
    assert calls == [1, 1, 1]
    assert ("phased_bam_bg" in split.stage_seconds) == (write_overlap == "1")
    assert _payloads(split) == _payloads(base)
    assert split.n_reads_tagged == base.n_reads_tagged > 0


def test_jax_batched_run_equals_port_in_waves(deep3, tmp_path, monkeypatch):
    bam, fa = deep3
    want = jax_run(bam, fa, str(tmp_path / "jax"),
                   jax_preset("hifi-masseq").replace(min_read_length=100,
                                                     threads=2), batched=True)
    monkeypatch.setenv("LONGCALLR_WAVE_CELLS", "1")
    got = run(bam, fa, str(tmp_path / "torch"),
              preset("hifi-masseq").replace(min_read_length=100, threads=2),
              batched=True, device=CPU)
    assert _payloads(got) == _payloads(want)


def test_finalize_fan_out_changes_nothing(genome, tmp_path, monkeypatch):
    bam, fa = genome
    cfg = preset("hifi-masseq").replace(threads=2)
    base = run(bam, fa, str(tmp_path / "serial"), cfg, batched=True,
               device=CPU)
    monkeypatch.setenv("LONGCALLR_FINALIZE_MT_CELLS", "1")
    fan = run(bam, fa, str(tmp_path / "fan"), cfg, batched=True, device=CPU)
    assert _payloads(fan) == _payloads(base)
    monkeypatch.setenv("LONGCALLR_FINALIZE_MT_CELLS", "many")
    with pytest.raises(ValueError, match="LONGCALLR_FINALIZE_MT_CELLS"):
        run(bam, fa, str(tmp_path / "bad"), cfg, batched=True, device=CPU)
    # the failed run leaves no partial phased BAM behind
    assert not os.path.exists(str(tmp_path / "bad.phased.bam"))


@pytest.mark.parametrize("name", goldens.GOLDEN_NAMES)
def test_preset_golden_batched(tmp_path, name):
    """The preset goldens through the batched pipeline (--batched)."""
    bam, fa, cfg, anno = goldens.golden_workload(name, str(tmp_path))
    out = run(bam, fa, str(tmp_path / "out"), cfg, anno_path=anno,
              batched=True, device=CPU)
    assert goldens.records_and_tags(out.vcf_path, out.phased_bam_path) \
        == goldens.golden(name)


@pytest.mark.parametrize("flag", [[], ["--batched"], ["--no-batched"]])
def test_cli_batched_flags(genome, tmp_path, flag):
    """The CLI with no flag (AUTO: batched here), --batched and
    --no-batched writes the same files; the count lines tell the path."""
    bam, fa = genome
    prefix = str(tmp_path / "cli")
    res = subprocess.run(
        [sys.executable, "-m", "longcallr_tpu_torch.cli", "-b", bam, "-f", fa,
         "-o", prefix, "-p", "hifi-masseq", "--platform", "cpu", *flag],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    buckets = [l for l in res.stdout.splitlines()
               if l.strip().startswith("count phase_buckets:")]
    if flag == ["--no-batched"]:
        assert not buckets
    else:
        assert buckets and int(buckets[0].split(":")[1]) >= 2
    direct = run(bam, fa, str(tmp_path / "direct"), preset("hifi-masseq"),
                 batched=False, device=CPU)
    with open(prefix + ".vcf", "rb") as f:
        assert f.read() == _payloads(direct)[0]
    assert bytes(decompress_file(prefix + ".phased.bam")) \
        == _payloads(direct)[1]


def test_stage_counts_are_counts(genome, tmp_path):
    bam, fa = genome
    out = run(bam, fa, str(tmp_path / "c"), preset("hifi-masseq"),
              batched=True, device=CPU)
    st = out.stage_seconds
    for k in STAGE_COUNTS & set(st):
        assert float(st[k]).is_integer(), k
    assert st["region_phase"] > 0 and st["phase_perturb"] > 0
    # f64 mode on the CPU: the staged chain, no fused program
    assert st["phase_ascent1"] > 0 and st.get("phase_fused", 0) == 0


def test_write_overlap_refuses_regions_out_of_order(genome, tmp_path):
    """The overlapped writer's bound needs each contig's regions in
    ascending start order; it raises (not asserts) when they are not."""
    from longcallr_tpu_torch.io.bam import BamFile
    from longcallr_tpu_torch.io.fasta import FastaFile

    bam_p, fa = genome
    bam = BamFile(bam_p)
    fasta = FastaFile(fa)
    regions = [Region(chr="chrA", start=20000, end=30000),
               Region(chr="chrA", start=2000, end=9000)]
    ov = TCALL._ResidentWriteOverlap(bam, regions, fasta.contig_lengths,
                                     str(tmp_path / "x.phased.bam"),
                                     preset("hifi-masseq"))
    # the stable sort puts them in order: a pre-sorted list passes
    ov._futs[0].result()
    ov.abort()
    ov = TCALL._ResidentWriteOverlap(bam, regions, fasta.contig_lengths,
                                     str(tmp_path / "y.phased.bam"),
                                     preset("hifi-masseq"))
    ov._futs[0].result()
    ov._regions = ov._regions[::-1]          # break the invariant
    with pytest.raises(RuntimeError, match="ascending start"):
        ov._prepass()
    ov.abort()
    assert not os.path.exists(str(tmp_path / "y.phased.bam"))


def test_resume_still_raises(genome, tmp_path):
    """resume=True is ported: the batched run keeps a checkpoint and writes
    the bytes of a run without one (tests/test_torch_stream_resume.py holds
    the rest). What still raises is a checkpoint that cannot be opened."""
    bam, fa = genome
    cfg = preset("hifi-masseq").replace(threads=2)
    out = run(bam, fa, str(tmp_path / "r"), cfg, resume=True, batched=True,
              device=CPU)
    base = run(bam, fa, str(tmp_path / "b"), cfg, batched=True, device=CPU)
    assert _payloads(out) == _payloads(base)
    with open(str(tmp_path / "r.regions.ckpt")) as f:
        assert len(f.read().splitlines()) == 1 + out.n_regions
    assert not os.path.exists(str(tmp_path / "b.regions.ckpt"))
    with pytest.raises(OSError):
        run(bam, fa, str(tmp_path / "no_such_dir" / "r"), cfg, resume=True,
            batched=True, device=CPU)
