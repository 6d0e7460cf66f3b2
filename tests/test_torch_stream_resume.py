"""The torch port's ``--stream`` and ``--resume`` on the CPU.

The multi-contig workload of ``tests/test_stream_genome.py`` goes through
the port's resident run, the port's ``run_streaming`` and the JAX package's
``run_streaming`` (CPU backend); the resume cases are the counterparts of
``tests/test_end_to_end.py`` (rerun, stale config, empty checkpoint file,
wave granularity of the batched pipeline) and of the stream's resume test,
plus checkpoints handed from one package to the other. Tolerance: none,
these are bytes (VCF bytes, HP/PS tags, phased-BAM payloads; compressed
bytes inside one package).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from longcallr_tpu.config import preset as jax_preset
from longcallr_tpu.pipeline import caller as JCALL
from longcallr_tpu.pipeline import resume as JRES
from longcallr_tpu.pipeline.engine import RegionResult as JRegionResult
from longcallr_tpu.tiles.regions import Region as JRegion
from longcallr_tpu_torch import cli
from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io import bam as bamio
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.io.bgzf import decompress_file
from longcallr_tpu_torch.io.fasta import write_fasta
from longcallr_tpu_torch.ops import candidates as TC
from longcallr_tpu_torch.phasing import batch_driver as TBD
from longcallr_tpu_torch.phasing import cuda_kernels as CK
from longcallr_tpu_torch.pipeline import caller as TCALL
from longcallr_tpu_torch.pipeline import resume as TRES
from longcallr_tpu_torch.pipeline.caller import run, run_streaming
from longcallr_tpu_torch.pipeline.engine import RegionResult
from longcallr_tpu_torch.tiles.regions import Region
from longcallr_tpu_torch.utils.bench_workload import make_genome_workload
from longcallr_tpu_torch.utils.simulate import (make_reference, plant_snps,
                                                simulate_bam)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# tests/test_stream_genome.py: 3 contigs, 7 loci, coverage 40-200
GENOME = [("chrA", [(25_000, 40, 160), (15_000, 60, 200)]),
          ("chrB", [(20_000, 200, 200), (8_000, 50, 150)]),
          ("chrC", [(12_000, 40, 160), (12_000, 40, 300), (8_000, 80, 150)])]
TWO_CONTIGS = [("chrA", [(15_000, 40, 200)]), ("chrB", [(15_000, 60, 200)])]


def _read(path, mode="rb"):
    with open(path, mode) as f:
        return f.read()


def _tags(path):
    b = BamFile(path)
    return {r.qname: (r.get_tag("HP"), r.get_tag("PS"))
            for r in (b.read(i) for i in range(b.n_records))}


def _payload(path):
    return bytes(decompress_file(path))


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """The genome workload and its four runs: the port resident, the port
    streaming, the port streaming without prefetch, the JAX package
    streaming."""
    d = tmp_path_factory.mktemp("stream")
    bam, fa = str(d / "genome.bam"), str(d / "genome.fa")
    params = make_genome_workload(bam, fa, contigs=GENOME)
    cfg = preset("hifi-masseq").replace(threads=2)
    outs = {"params": params, "bam": bam, "fa": fa}
    outs["full"] = run(bam, fa, str(d / "full"), cfg, device=CPU)
    outs["stream"] = run_streaming(bam, fa, str(d / "stream"), cfg,
                                   device=CPU)
    os.environ["LONGCALLR_STREAM_PREFETCH"] = "0"
    try:
        outs["plain"] = run_streaming(bam, fa, str(d / "plain"), cfg,
                                      device=CPU)
    finally:
        del os.environ["LONGCALLR_STREAM_PREFETCH"]
    outs["jax"] = JCALL.run_streaming(
        bam, fa, str(d / "jax"), jax_preset("hifi-masseq").replace(threads=2))
    return outs


@pytest.mark.parametrize("what", ["vcf_bytes", "tags", "payload",
                                  "prefetch_off", "counters", "windows"])
def test_stream_equals_resident_equals_jax(genome, what):
    full, stream, plain, jax_out = (genome[k] for k in
                                    ("full", "stream", "plain", "jax"))
    if what == "vcf_bytes":
        v = _read(stream.vcf_path)
        assert v == _read(full.vcf_path) == _read(jax_out.vcf_path)
        chroms = {l.split(b"\t")[0] for l in v.splitlines()
                  if not l.startswith(b"#")}
        assert chroms == {b"chrA", b"chrB", b"chrC"}
        assert stream.n_records == full.n_records == jax_out.n_records > 0
    elif what == "tags":
        t = _tags(stream.phased_bam_path)
        assert t == _tags(full.phased_bam_path)
        assert t == _tags(jax_out.phased_bam_path)
        assert sum(hp is not None for hp, _ in t.values()) > 1000
    elif what == "payload":
        # between the packages the payload (each builds its own deflate
        # codec); inside the port the resident run's too
        p = _payload(stream.phased_bam_path)
        assert p == _payload(jax_out.phased_bam_path)
        assert p == _payload(full.phased_bam_path)
    elif what == "prefetch_off":
        # LONGCALLR_STREAM_PREFETCH=0 and =1: the same bytes, BGZF framing
        # of the phased BAM included
        assert _read(plain.vcf_path) == _read(stream.vcf_path)
        assert _read(plain.phased_bam_path) == _read(stream.phased_bam_path)
        assert "bam_write_drain" not in plain.stage_seconds
    elif what == "counters":
        st = stream.stage_seconds
        for k in ("window_load", "discovery", "bam_emit", "total",
                  "region_phase", "region_pileup"):
            assert st[k] > 0, k
        # summed over the contigs, not the last contig's alone (a
        # resident bucket may hold regions of several contigs)
        assert st["phase_buckets"] >= full.stage_seconds["phase_buckets"] >= 3
        assert stream.n_regions == full.n_regions == jax_out.n_regions == 7
        assert stream.n_reads_tagged == full.n_reads_tagged \
            == jax_out.n_reads_tagged > 0
        assert stream.n_fragments == jax_out.n_fragments
        assert stream.n_assigned_reads == jax_out.n_assigned_reads
        assert stream.n_phased_sites == jax_out.n_phased_sites > 0
        assert st["phase_host_placed"] + st["phase_card_placed"] > 0
        assert st["phase_card_placed"] == 0          # a CPU run
    else:
        whole = BamFile(genome["bam"])
        wins = [BamFile(genome["bam"], region=(c, 0, 10 ** 9))
                for c in ("chrA", "chrB", "chrC")]
        assert all(w.n_records < whole.n_records for w in wins)
        assert sum(w.n_records for w in wins) == whole.n_records \
            == genome["params"]["n_reads"] > 2500


@pytest.fixture
def two_contigs(tmp_path):
    bam, fa = str(tmp_path / "g2.bam"), str(tmp_path / "g2.fa")
    make_genome_workload(bam, fa, contigs=TWO_CONTIGS)
    return bam, fa


def test_stream_needs_an_index(two_contigs, tmp_path):
    bam, fa = two_contigs
    with pytest.raises(ValueError, match="exon_only"):
        run_streaming(bam, fa, str(tmp_path / "x"),
                      preset("hifi-masseq").replace(exon_only=True),
                      device=CPU)
    os.remove(bam + ".bai")
    with pytest.raises(ValueError, match="needs a BAM index"):
        run_streaming(bam, fa, str(tmp_path / "x"), preset("hifi-masseq"),
                      device=CPU)


def test_stream_without_a_device_asks_for_cuda(two_contigs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    bam, fa = two_contigs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_streaming(bam, fa, str(tmp_path / "x"), preset("hifi-masseq"))


def test_stream_per_contig_paths_and_no_bam_output(two_contigs, tmp_path,
                                                   monkeypatch):
    """One region per contig: AUTO takes the per-region loop in every
    contig, batched=True the batched pipeline; the bytes are the same, and
    no_bam_output writes no BAM."""
    bam, fa = two_contigs
    calls = []
    orig = TCALL._run_batched
    monkeypatch.setattr(TCALL, "_run_batched",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    cfg = preset("hifi-masseq").replace(threads=2)
    auto = run_streaming(bam, fa, str(tmp_path / "auto"), cfg, device=CPU)
    assert not calls and auto.n_regions == 2
    forced = run_streaming(bam, fa, str(tmp_path / "forced"), cfg,
                           batched=True, device=CPU)
    assert len(calls) == 2
    assert _read(auto.vcf_path) == _read(forced.vcf_path)
    assert _read(auto.phased_bam_path) == _read(forced.phased_bam_path)
    only = run_streaming(bam, fa, str(tmp_path / "only"), cfg,
                         contigs=["chrB"], device=CPU)
    assert only.n_regions == 1
    lines = [l for l in _read(only.vcf_path, "r").splitlines()
             if not l.startswith("#")]
    assert lines and all(l.startswith("chrB\t") for l in lines)
    none = run_streaming(bam, fa, str(tmp_path / "none"),
                         cfg.replace(no_bam_output=True), device=CPU)
    assert none.phased_bam_path is None
    assert not os.path.exists(str(tmp_path / "none.phased.bam"))
    assert _read(none.vcf_path) == _read(auto.vcf_path)


def test_stream_failure_closes_the_writer_and_keeps_the_error(two_contigs,
                                                              tmp_path,
                                                              monkeypatch):
    """A failure in the second contig's pipeline propagates as itself; the
    phased BAM written so far is closed with its EOF block."""
    bam, fa = two_contigs
    calls = {"n": 0}
    orig = TCALL.process_region

    def boom(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected crash")
        return orig(*a, **kw)

    monkeypatch.setattr(TCALL, "process_region", boom)
    with pytest.raises(RuntimeError, match="injected crash"):
        run_streaming(bam, fa, str(tmp_path / "f"), preset("hifi-masseq"),
                      device=CPU)
    part = BamFile(str(tmp_path / "f.phased.bam"))     # readable: EOF block
    assert 0 < part.n_records < BamFile(bam).n_records


def _main(*args):
    return cli.main(["-p", "hifi-masseq", "--platform", "cpu", *args])


def test_cli_stream_with_region_returns_2(two_contigs, tmp_path, capsys):
    bam, fa = two_contigs
    rc = _main("-b", bam, "-f", fa, "-o", str(tmp_path / "x"), "--stream",
               "-r", "chrA:1-5000")
    assert rc == 2
    assert "--stream does not take -r" in capsys.readouterr().err
    assert not os.path.exists(str(tmp_path / "x.vcf"))


@pytest.mark.parametrize("flags,auto_mb,streams", [
    ([], "0.001", True), ([], "1024", False), (["--no-stream"], "0.001", False),
    (["-r", "chrA:2000-17000"], "0.001", False), (["--stream"], "1024", True)])
def test_cli_stream_auto(two_contigs, tmp_path, monkeypatch, flags, auto_mb,
                         streams):
    """AUTO engages for an indexed BAM above LONGCALLR_STREAM_AUTO_MB, and
    not with -r or --no-stream."""
    bam, fa = two_contigs
    monkeypatch.setenv("LONGCALLR_STREAM_AUTO_MB", auto_mb)
    seen = []
    orig_s, orig_r = TCALL.run_streaming, TCALL.run
    monkeypatch.setattr(TCALL, "run_streaming",
                        lambda *a, **kw: seen.append("stream")
                        or orig_s(*a, **kw))
    monkeypatch.setattr(TCALL, "run",
                        lambda *a, **kw: seen.append("run")
                        or orig_r(*a, **kw))
    assert _main("-b", bam, "-f", fa, "-o", str(tmp_path / "o"), *flags) == 0
    assert seen == ["stream" if streams else "run"]
    assert ("window_load" in cli.LAST_RUN.stage_seconds) == streams


def test_cli_stream_and_resume_in_a_subprocess(two_contigs, tmp_path):
    """python -m longcallr_tpu_torch.cli --stream --resume --platform cpu,
    twice: the second run recomputes nothing and writes the same bytes."""
    bam, fa = two_contigs
    prefix = str(tmp_path / "cli")
    outs = []
    for _ in range(2):
        res = subprocess.run(
            [sys.executable, "-m", "longcallr_tpu_torch.cli", "-b", bam, "-f",
             fa, "-o", prefix, "-p", "hifi-masseq", "--platform", "cpu",
             "--stream", "--resume"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        outs.append((res.stdout, _read(prefix + ".vcf"),
                     _read(prefix + ".phased.bam")))
    assert "stage window_load:" in outs[0][0]
    assert "count phase_host_placed: 2" in outs[0][0]
    assert "count phase_host_placed: 0" in outs[1][0]
    assert outs[0][1:] == outs[1][1:]
    assert os.path.exists(prefix + ".regions.ckpt")


# --- resume ---------------------------------------------------------------

def _sim(tmp_path, rng, name="r.bam"):
    ref = make_reference(rng, 5000)
    truth = plant_snps(rng, ref, n_het=5, n_hom=1)
    bam = str(tmp_path / name)
    simulate_bam(bam, rng, ref, truth, n_reads=40, read_len=2500,
                 err_rate=0.01)
    return bam, bam.replace(".bam", ".fa")


def _count_phase_calls(monkeypatch):
    """Counts the regions that reach process_region (the per-region loop)."""
    calls = []
    orig = TCALL.process_region
    monkeypatch.setattr(TCALL, "process_region",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    return calls


def test_resume_checkpoint(tmp_path, rng, monkeypatch):
    """A resumed run skips completed regions and produces identical
    output."""
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    bam, fa = _sim(tmp_path, rng)
    calls = _count_phase_calls(monkeypatch)
    out1 = run(bam, fa, str(tmp_path / "o1"), cfg, resume=True, device=CPU)
    assert os.path.exists(str(tmp_path / "o1.regions.ckpt"))
    assert len(calls) == out1.n_regions >= 1
    first = _read(out1.vcf_path), _read(out1.phased_bam_path)
    calls.clear()
    out2 = run(bam, fa, str(tmp_path / "o1"), cfg, resume=True, device=CPU)
    assert not calls                         # every region skipped
    assert (_read(out2.vcf_path), _read(out2.phased_bam_path)) == first
    assert out2.n_records == out1.n_records > 0
    assert out2.stage_seconds["phase_host_placed"] == 0


def test_resume_discards_stale_config(tmp_path, rng):
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    bam, fa = _sim(tmp_path, rng, "s.bam")
    run(bam, fa, str(tmp_path / "s1"), cfg, resume=True, device=CPU)
    ckpt = str(tmp_path / "s1.regions.ckpt")
    with open(ckpt) as f:
        header = json.loads(f.readline())
    assert "__config__" in header
    cfg2 = cfg.replace(min_allele_freq=0.33)
    run(bam, fa, str(tmp_path / "s1"), cfg2, resume=True, device=CPU)
    with open(ckpt) as f:
        header2 = json.loads(f.readline())
        body = f.read().splitlines()
    assert header2["__config__"] != header["__config__"]
    assert body          # regions recomputed and stored under the new key
    size = os.path.getsize(ckpt)
    run(bam, fa, str(tmp_path / "s1"), cfg2, resume=True, device=CPU)
    assert os.path.getsize(ckpt) == size      # reused, file not regrown


def test_resume_empty_checkpoint_file(tmp_path):
    """A file with no parseable line stays fresh (the header is written
    before any result); a file holding only a torn tail too."""
    path = str(tmp_path / "e.ckpt")
    open(path, "w").close()
    ck = TRES.RegionCheckpoint(path, key="k1")
    reg = Region(chr="chr1", start=1, end=100)
    ck.put(RegionResult(reg, ["chr1\t5\t.\tA\tC"], {}, {}, 3, 1))
    ck.close()
    ck2 = TRES.RegionCheckpoint(path, key="k1")
    assert ck2.n_done == 1 and ck2.get(reg) is not None
    ck2.close()
    with open(path, "w") as f:
        f.write('{"chr": "chr1", "sta')
    ck3 = TRES.RegionCheckpoint(path, key="k1")
    assert ck3.n_done == 0
    ck3.put(RegionResult(reg, [], {}, {}, 0, 0))
    ck3.close()
    ck4 = TRES.RegionCheckpoint(path, key="k1")
    assert ck4.n_done == 1
    ck4.close()


def _two_region_bam(tmp_path, rng):
    """Two well-separated regions on one contig (the input of
    tests/test_end_to_end.py::test_batched_resume_wave_granularity)."""
    ref = make_reference(rng, 14000)
    t1 = plant_snps(rng, ref[:6000], n_het=5, n_hom=1)
    bam = str(tmp_path / "wg.bam")
    with bamio.BamWriter(bam, ["chrS"], [len(ref)]) as w:
        k = 0
        for base in (0, 8000):
            for _ in range(30):
                s = base + int(rng.integers(0, 1500))
                e = min(s + 2500, base + 5500)
                seq = bytearray(ref[s:e])
                for pos, (a, b) in t1.het_snps.items():
                    p = pos + base
                    if s <= p < e:
                        seq[p - s] = [a, b][k % 2]
                w.write_record(qname=f"r{k}", flag=0, ref_id=0, pos=s,
                               mapq=60,
                               cigar=bamio.encode_cigar([(len(seq), "M")]),
                               seq=bytes(seq),
                               qual=np.full(len(seq), 30, np.uint8),
                               tags=bamio.make_tag_bytes("de", "f", 0.001))
                k += 1
    fa = str(tmp_path / "wg.fa")
    write_fasta(fa, {"chrS": bytes(ref)})
    return bam, fa


@pytest.mark.parametrize("wave_overlap", ["1", "0"])
def test_batched_resume_wave_granularity(tmp_path, rng, monkeypatch,
                                         wave_overlap):
    """The batched pipeline checkpoints per wave: a crash in the second
    wave's phasing leaves the first wave's region in the checkpoint, with
    the wave overlap on and off, and the resumed run recomputes only the
    second and ends with the bytes of an uninterrupted run."""
    cfg = preset("hifi-masseq").replace(min_read_length=100, threads=2)
    bam, fa = _two_region_bam(tmp_path, rng)
    monkeypatch.setenv("LONGCALLR_WAVE_OVERLAP", wave_overlap)
    monkeypatch.setattr(TC, "CAND_BATCH_COLS", 1)    # one region per wave
    calls = {"n": 0}
    orig = TBD.phase_regions_batched

    def boom(items, cfg_, device=None, mesh=None):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected crash")
        return orig(items, cfg_, device=device, mesh=mesh)

    monkeypatch.setattr(TBD, "phase_regions_batched", boom)
    with pytest.raises(RuntimeError, match="injected crash"):
        run(bam, fa, str(tmp_path / "o1"), cfg, resume=True, batched=True,
            device=CPU)
    assert not os.path.exists(str(tmp_path / "o1.phased.bam"))
    lines = _read(str(tmp_path / "o1.regions.ckpt"), "r").splitlines()
    assert "__config__" in json.loads(lines[0])
    assert len(lines) == 2, "wave 1 not checkpointed"

    seen = []
    monkeypatch.setattr(
        TBD, "phase_regions_batched",
        lambda items, cfg_, device=None, mesh=None: seen.append(len(items))
        or orig(items, cfg_, device=device, mesh=mesh))
    out = run(bam, fa, str(tmp_path / "o1"), cfg, resume=True, batched=True,
              device=CPU)
    assert seen == [1]                       # only what was lost
    fresh = run(bam, fa, str(tmp_path / "o2"), cfg, batched=True, device=CPU)
    assert out.n_regions == fresh.n_regions == 2
    assert _read(out.vcf_path) == _read(fresh.vcf_path)
    assert _read(out.phased_bam_path) == _read(fresh.phased_bam_path)
    assert out.n_records > 0


def test_stream_resume_multi_contig(two_contigs, tmp_path, monkeypatch):
    bam, fa = two_contigs
    cfg = preset("hifi-masseq").replace(threads=2)
    calls = _count_phase_calls(monkeypatch)
    first = run_streaming(bam, fa, str(tmp_path / "s"), cfg, resume=True,
                          device=CPU)
    assert os.path.exists(str(tmp_path / "s.regions.ckpt"))
    assert len(calls) == 2
    a = _read(first.vcf_path), _read(first.phased_bam_path)
    calls.clear()
    again = run_streaming(bam, fa, str(tmp_path / "s"), cfg, resume=True,
                          device=CPU)
    assert not calls
    assert (_read(again.vcf_path), _read(again.phased_bam_path)) == a
    # the stream's checkpoint serves a resident rerun too (same key)
    res = run(bam, fa, str(tmp_path / "s"), cfg, resume=True, device=CPU)
    assert not calls and _read(res.vcf_path) == a[0]


def test_resume_recomputes_what_a_cut_checkpoint_lost(tmp_path, monkeypatch):
    """A checkpoint cut to its header and first half: the rerun recomputes
    the rest and writes the same bytes."""
    bam, fa = str(tmp_path / "g.bam"), str(tmp_path / "g.fa")
    make_genome_workload(bam, fa, contigs=[
        ("chrA", [(6000, 20, 160), (5000, 30, 200)]),
        ("chrB", [(6000, 40, 200), (4000, 25, 150)])])
    cfg = preset("hifi-masseq").replace(threads=2)
    first = run(bam, fa, str(tmp_path / "c"), cfg, resume=True, device=CPU)
    want = _read(first.vcf_path), _read(first.phased_bam_path)
    ckpt = str(tmp_path / "c.regions.ckpt")
    lines = _read(ckpt, "r").splitlines(keepends=True)
    assert len(lines) == 1 + first.n_regions == 5
    with open(ckpt, "w") as f:
        f.writelines(lines[:3])
        f.write(lines[3][:40])               # and a torn last line
    seen = []
    orig = TBD.phase_regions_batched
    monkeypatch.setattr(
        TBD, "phase_regions_batched",
        lambda items, cfg_, device=None, mesh=None: seen.append(len(items))
        or orig(items, cfg_, device=device, mesh=mesh))
    again = run(bam, fa, str(tmp_path / "c"), cfg, resume=True, device=CPU)
    assert sum(seen) == 2
    assert (_read(again.vcf_path), _read(again.phased_bam_path)) == want


# --- one package's checkpoint in the other ----------------------------------

@pytest.mark.parametrize("name", ["hifi-masseq", "ont-cdna"])
def test_config_key_is_the_same_in_both_packages(tmp_path, name):
    vcf = str(tmp_path / "in.vcf")
    with open(vcf, "w") as f:
        f.write("##fileformat=VCFv4.2\n")
    for kw in ({}, {"min_allele_freq": 0.33, "threads": 3}):
        a = JRES.config_key(jax_preset(name).replace(**kw))
        b = TRES.config_key(preset(name).replace(**kw))
        assert a == b and len(a) == 16
    assert (JRES.config_key(jax_preset(name), vcf, str(tmp_path / "no.gtf"))
            == TRES.config_key(preset(name), vcf, str(tmp_path / "no.gtf")))
    assert TRES.config_key(preset(name), vcf) != TRES.config_key(preset(name))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_written_by_one_package_is_read_by_the_other(
        tmp_path, rng, monkeypatch, writer):
    """The same run with resume in one package, then in the other on the
    same prefix: nothing is recomputed, the bytes are equal, and both wrote
    the same JSONL lines for the same regions."""
    bam, fa = _sim(tmp_path, rng)
    jcfg = jax_preset("hifi-masseq").replace(min_read_length=100)
    tcfg = preset("hifi-masseq").replace(min_read_length=100)
    jrun = lambda p: JCALL.run(bam, fa, p, jcfg, resume=True)
    trun = lambda p: run(bam, fa, p, tcfg, resume=True, device=CPU)
    shared, other = str(tmp_path / "shared"), str(tmp_path / "other")
    first = (jrun if writer == "jax" else trun)(shared)
    # the other package from scratch: the same checkpoint lines
    (trun if writer == "jax" else jrun)(other)
    assert _read(shared + ".regions.ckpt") == _read(other + ".regions.ckpt")
    want = _read(first.vcf_path), _payload(first.phased_bam_path)
    size = os.path.getsize(shared + ".regions.ckpt")
    if writer == "jax":
        calls = _count_phase_calls(monkeypatch)
        second = trun(shared)
    else:
        calls = []
        orig = JCALL.process_region
        monkeypatch.setattr(JCALL, "process_region",
                            lambda *a, **kw: calls.append(1)
                            or orig(*a, **kw))
        second = jrun(shared)
    assert not calls
    assert os.path.getsize(shared + ".regions.ckpt") == size
    assert (_read(second.vcf_path), _payload(second.phased_bam_path)) == want
    assert second.n_records == first.n_records > 0


def test_region_results_cross_the_packages(tmp_path):
    """put() in one package, get() in the other, both ways, with a gene id
    and a torn last line."""
    res = dict(vcf_lines=["chr1\t5\t.\tA\tC\t30\tPASS\t.\tGT\t0|1"],
               read_assignments={"q1": 1, "q2": 2}, phase_sets={"q1": 5},
               n_fragments=3, n_candidates=1)
    reg = dict(chr="chr1", start=1, end=100, gene_id="G1,G2")
    for wmod, wres, wreg, rmod, rreg in (
            (JRES, JRegionResult, JRegion, TRES, Region),
            (TRES, RegionResult, Region, JRES, JRegion)):
        path = str(tmp_path / f"{wmod.__name__}.ckpt")
        ck = wmod.RegionCheckpoint(path, key="k")
        ck.put(wres(region=wreg(**reg), **res))
        ck.close()
        with open(path, "a") as f:
            f.write('{"chr": "chr1", "start": 200, "en')
        back = rmod.RegionCheckpoint(path, key="k")
        assert back.n_done == 1
        got = back.get(rreg(**reg))
        back.close()
        assert got is not None and type(got.region) is rreg
        assert {k: getattr(got, k) for k in res} == res
        stale = rmod.RegionCheckpoint(path, key="other")
        assert stale.n_done == 0
        stale.close()


def test_cpu_runs_launch_no_kernel(genome):
    assert CK.LAUNCHES == {"dual_matvec_rows": 0, "matvec_cols": 0}
