"""The port's pod mode (``parallel/multihost.py`` on torch.distributed with
gloo) against the JAX package's on the CPU.

The counterparts of the pod tests of ``tests/test_parallel.py``: the LPT
shard assignment equal to the JAX function's; the gather's identity,
timeout, peer-loss and failure handling (faked collectives); a 2-process
split faked in one process (merge, retry of a dropped region, ``-v`` and
``--resume``); real 2-process gloo pods through the CLI, resident and
``--stream``; a pod whose second process is SIGKILLed mid-shard; and the
CLI's argument checks. Tolerance: none, these are bytes (VCF bytes, HP/PS
tags, phased-BAM payloads). Every subprocess runs under a timeout and is
killed on expiry, so a hung gather fails one test only.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from longcallr_tpu.config import preset as jax_preset
from longcallr_tpu.parallel import multihost as JMH
from longcallr_tpu.pipeline.caller import run as jax_run
from longcallr_tpu.tiles.regions import Region as JaxRegion
from longcallr_tpu_torch import cli
from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.io.bgzf import decompress_file
from longcallr_tpu_torch.io.fasta import FastaFile
from longcallr_tpu_torch.io.vcf import load_input_candidates
from longcallr_tpu_torch.parallel import multihost as MH
from longcallr_tpu_torch.pipeline.caller import build_regions, run
from longcallr_tpu_torch.pipeline.resume import RegionCheckpoint, config_key
from longcallr_tpu_torch.tiles.regions import Region
from longcallr_tpu_torch.utils.bench_workload import make_genome_workload
from longcallr_tpu_torch.utils.simulate import (make_reference, plant_snps,
                                                simulate_bam)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
POD_TIMEOUT = 240

# the genome of tests/test_parallel.py::test_run_multihost_streaming_pod
GENOME = [("chrA", [(15_000, 40, 200)]),
          ("chrB", [(12_000, 60, 200), (8_000, 40, 160)]),
          ("chrC", [(10_000, 50, 180)])]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _tags(path):
    b = BamFile(path)
    return sorted((r.qname, r.get_tag("HP"), r.get_tag("PS"))
                  for r in (b.read(i) for i in range(b.n_records)))


def _cfg():
    return preset("hifi-masseq").replace(min_read_length=100)


def _jcfg():
    return jax_preset("hifi-masseq").replace(min_read_length=100)


# --- shard assignment and the gather -----------------------------------------

def _random_regions(seed):
    r = np.random.default_rng(seed)
    return [(int(r.integers(100, 50_000)), int(r.integers(1, 3_000)))
            for _ in range(int(r.integers(5, 40)))]


@pytest.mark.parametrize("spec", [
    [(1000, 100), (5000, 10), (200, 2000), (800, 50), (3000, 30), (100, 10)],
    *(_random_regions(s) for s in range(3))])
def test_shard_regions_matches_jax(spec):
    regions = [Region(chr="c", start=1, end=1 + ln, max_coverage=cov)
               for ln, cov in spec]
    jregions = [JaxRegion(chr="c", start=1, end=1 + ln, max_coverage=cov)
                for ln, cov in spec]
    for n in (1, 2, 3, 5):
        shards = [MH.shard_regions(regions, n, p) for p in range(n)]
        assert shards == [JMH.shard_regions(jregions, n, p) for p in range(n)]
        assert sorted(i for s in shards for i in s) == list(range(len(spec)))


def test_gather_results_identity():
    local = {3: {"vcf_lines": ["a\tb"], "n_fragments": 7}}
    assert MH.gather_results(local) == local
    assert not MH.gather_degraded()


def test_gather_results_timeout(monkeypatch):
    """A peer stuck inside the all_gather: the timeout wrapper returns the
    local payloads so process 0 can retry the rest serially, and poisons
    later gathers."""
    monkeypatch.setattr(MH, "_process_count", lambda: 2)
    monkeypatch.setattr(MH, "_gather_poisoned", False)
    monkeypatch.setattr(MH, "_gather_collective",
                        lambda local: time.sleep(30) or dict(local))
    local = {5: {"vcf_lines": ["x"], "n_fragments": 1}}
    t0 = time.monotonic()
    assert MH.gather_results(local, timeout_s=0.3) == local
    assert time.monotonic() - t0 < 5
    assert MH.gather_degraded()
    with pytest.raises(RuntimeError, match="timed out"):
        MH.gather_results(local, timeout_s=5.0)
    monkeypatch.setattr(MH, "_gather_poisoned", False)
    monkeypatch.setattr(MH, "_gather_collective",
                        lambda local: {**local, 9: {"vcf_lines": []}})
    assert 9 in MH.gather_results(local, timeout_s=5.0)


def _raise(msg):
    def collective(local):
        raise RuntimeError(msg)
    return collective


@pytest.mark.parametrize("timeout_s", [None, 5.0])
def test_gather_results_peer_lost_keeps_local(monkeypatch, timeout_s):
    """gloo fails a collective whose peer died ("Connection closed by
    peer"): the survivor keeps its local results, degraded."""
    monkeypatch.setattr(MH, "_process_count", lambda: 2)
    monkeypatch.setattr(MH, "_gather_poisoned", False)
    monkeypatch.setattr(MH, "_gather_collective", _raise(
        "[gloo/transport/tcp/pair.cc:553] Connection closed by peer "
        "[127.0.0.1]:716. This is typically caused by a remote worker "
        "crashing."))
    local = {2: {"vcf_lines": ["y"]}}
    assert MH.gather_results(local, timeout_s=timeout_s) == local
    assert MH.gather_degraded()


@pytest.mark.parametrize("timeout_s", [None, 5.0])
def test_gather_results_failure_is_reraised(monkeypatch, timeout_s):
    """A gather that fails for another reason is re-raised, not reported as
    a timeout or a lost peer."""
    monkeypatch.setattr(MH, "_process_count", lambda: 2)
    monkeypatch.setattr(MH, "_gather_poisoned", False)
    monkeypatch.setattr(MH, "_gather_collective",
                        _raise("unsupported dtype in all_gather"))
    with pytest.raises(RuntimeError, match="unsupported dtype"):
        MH.gather_results({1: {}}, timeout_s=timeout_s)
    assert MH.gather_degraded()      # peers may be mid-collective


# --- the shard stages in one process -------------------------------------------

def _two_locus_bam(tmp_path, rng, name, n_het=6, with_vcf=False):
    ref = make_reference(rng, 16000 if not with_vcf else 12000)
    truth = plant_snps(rng, ref, n_het=n_het, n_hom=0 if with_vcf else 1,
                       min_gap=1800 if not with_vcf else 1500)
    bam = str(tmp_path / f"{name}.bam")
    simulate_bam(bam, rng, ref, truth, n_reads=60, read_len=3000,
                 err_rate=0.01)
    return bam, bam.replace(".bam", ".fa"), truth


def test_shard_merge_retry_matches_single_and_jax(tmp_path, rng):
    """Both shards of a faked 2-process split through run_local_shard, one
    region dropped from the merge (a peer that crashed) and retried by
    serialize_outputs: the VCF bytes and phased-BAM payload of the port's
    single-process run, which equal the JAX package's."""
    bam_path, fa, _ = _two_locus_bam(tmp_path, rng, "mh2")
    cfg = _cfg()
    single = run(bam_path, fa, str(tmp_path / "single"), cfg, device=CPU)
    jsingle = jax_run(bam_path, fa, str(tmp_path / "jsingle"), _jcfg())
    bam, fasta = BamFile(bam_path), FastaFile(fa)
    regions, _ = build_regions(bam, fasta, cfg)
    assert regions
    loc0, f0 = MH.run_local_shard(bam, fasta, regions,
                                  MH.shard_regions(regions, 2, 0), cfg,
                                  device=CPU)
    loc1, f1 = MH.run_local_shard(bam, fasta, regions,
                                  MH.shard_regions(regions, 2, 1), cfg,
                                  device=CPU)
    assert not f0 and not f1
    merged = {**loc0, **loc1}
    del merged[sorted(merged)[0]]
    out = MH.serialize_outputs(bam, fasta, regions, merged, cfg,
                               str(tmp_path / "pod"), device=CPU)
    assert out["n_retried"] == 1
    pod_vcf = _read(out["vcf_path"])
    assert pod_vcf == _read(single.vcf_path) == _read(jsingle.vcf_path)
    assert (decompress_file(out["phased_bam_path"])
            == decompress_file(single.phased_bam_path))
    assert _tags(out["phased_bam_path"]) == _tags(jsingle.phased_bam_path)


def test_shard_honors_input_vcf_and_resume(tmp_path, rng):
    """The sharded path threads -v candidates and the resume checkpoint as
    pipeline/caller.run does; a second shard pass reuses the checkpoint."""
    bam_path, fa, truth = _two_locus_bam(tmp_path, rng, "mhv", with_vcf=True)
    vcf_in = str(tmp_path / "in.vcf")
    with open(vcf_in, "w") as f:
        f.write("##fileformat=VCFv4.3\n#CHROM\tPOS\tID\tREF\tALT\tQUAL"
                "\tFILTER\tINFO\tFORMAT\tS\n")
        for p, (refb, altb) in sorted(truth.het_snps.items()):
            f.write(f"chrS\t{p+1}\t.\t{chr(refb)}\t{chr(altb)}\t60\tPASS"
                    f"\t.\tGT\t0/1\n")
    cfg = _cfg()
    single = run(bam_path, fa, str(tmp_path / "sv"), cfg, input_vcf=vcf_in,
                 device=CPU)
    jsingle = jax_run(bam_path, fa, str(tmp_path / "jsv"), _jcfg(),
                      input_vcf=vcf_in)
    bam, fasta = BamFile(bam_path), FastaFile(fa)
    regions, _ = build_regions(bam, fasta, cfg)
    cands_in = load_input_candidates(vcf_in)
    ckpt_path = str(tmp_path / "pod.regions.p0.ckpt")
    ckpt = RegionCheckpoint(ckpt_path, key=config_key(cfg, vcf_in, None))
    sh0 = MH.shard_regions(regions, 2, 0)
    loc0, f0 = MH.run_local_shard(bam, fasta, regions, sh0, cfg,
                                  input_candidates=cands_in, ckpt=ckpt,
                                  device=CPU)
    ckpt.close()
    loc1, f1 = MH.run_local_shard(bam, fasta, regions,
                                  MH.shard_regions(regions, 2, 1), cfg,
                                  input_candidates=cands_in, device=CPU)
    assert not f0 and not f1
    out = MH.serialize_outputs(bam, fasta, regions, {**loc0, **loc1}, cfg,
                               str(tmp_path / "pod"),
                               input_candidates=cands_in, device=CPU)
    pod_vcf = _read(out["vcf_path"])
    assert pod_vcf == _read(single.vcf_path) == _read(jsingle.vcf_path)
    body = [ln for ln in pod_vcf.decode().splitlines()
            if not ln.startswith("#")]
    assert {int(ln.split("\t")[1]) - 1 for ln in body} == set(truth.het_snps)
    ckpt2 = RegionCheckpoint(ckpt_path, key=config_key(cfg, vcf_in, None))
    assert ckpt2.n_done == len(loc0)
    loc0b, _ = MH.run_local_shard(bam, fasta, regions, sh0, cfg,
                                  input_candidates=cands_in, ckpt=ckpt2,
                                  device=CPU)
    ckpt2.close()
    assert loc0b == loc0


def test_one_process_stream_with_a_region_raises(tmp_path, rng):
    """The JAX package streams the whole BAM here and drops the region; the
    port refuses, as the multi-process path does."""
    bam_path, fa, _ = _two_locus_bam(tmp_path, rng, "mhs")
    with pytest.raises(ValueError, match="input region"):
        MH.run_multihost(bam_path, fa, str(tmp_path / "x"), _cfg(),
                         stream=True, device=CPU, input_region="chrS:1-5000")


@pytest.mark.parametrize("given", [("--coordinator", "localhost:1"),
                                   ("--num-processes", "2"),
                                   ("--process-id", "0")])
def test_pod_flags_in_part_return_2(tmp_path, capsys, given):
    rc = cli.main(["-b", str(tmp_path / "a.bam"), "-f", str(tmp_path / "a.fa"),
                   "-o", str(tmp_path / "o"), "-p", "hifi-masseq",
                   "--platform", "cpu", *given])
    assert rc == 2
    assert "must be given together" in capsys.readouterr().err


# --- real pods ------------------------------------------------------------------

_POD_WORKER = r"""
import os, signal, sys
port, pid, bam, fa, out, mode, marker = sys.argv[1:8]
if marker != "-" and pid == "1":
    # die MID-SHARD: after the phasing pass, before finalize and gather —
    # an abrupt SIGKILL (no cleanup), the failure of a preempted worker
    import longcallr_tpu_torch.phasing.batch_driver as bd
    orig = bd.phase_regions_batched
    def dying(items, cfg, device=None):
        res = orig(items, cfg, device=device)
        with open(marker, "w") as f:
            f.write("mid-shard")
        os.kill(os.getpid(), signal.SIGKILL)
        return res
    bd.phase_regions_batched = dying
from longcallr_tpu_torch import cli
rc = cli.main(["-b", bam, "-f", fa, "-o", out, "-p", "hifi-masseq",
               "--platform", "cpu", "--min-read-length", "100", "-t", "1",
               "--coordinator", f"localhost:{port}", "--num-processes", "2",
               "--process-id", pid, mode])
print("DONE", pid, rc, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pod(tmp_path, bam, fa, out, mode, marker="-", env=None):
    """Two worker processes of one pod; returns [(returncode, stdout,
    stderr)] by process id. Output goes to files (a full pipe would stall
    a worker mid-collective); a worker still running at the timeout is
    killed and fails the test."""
    worker = str(tmp_path / "pod_worker.py")
    with open(worker, "w") as f:
        f.write(_POD_WORKER)
    port = _free_port()
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs, logs = [], []
    try:
        for pid in (0, 1):
            so = open(tmp_path / f"w{pid}.out", "w+")
            se = open(tmp_path / f"w{pid}.err", "w+")
            logs.append((so, se))
            procs.append(subprocess.Popen(
                [sys.executable, worker, str(port), str(pid), bam, fa, out,
                 mode, marker], cwd=REPO, env=env, stdout=so, stderr=se))
        deadline = time.monotonic() + POD_TIMEOUT
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail("a pod worker did not finish in time")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for p, (so, se) in zip(procs, logs):
        so.seek(0)
        se.seek(0)
        res.append((p.returncode, so.read(), se.read()))
        so.close()
        se.close()
    return res


def _summary(stdout: str) -> dict:
    return [json.loads(ln) for ln in stdout.splitlines()
            if ln.startswith('{"process"')][0]


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """The genome workload and its single-process runs: the port's and the
    JAX package's."""
    d = tmp_path_factory.mktemp("pod")
    bam, fa = str(d / "podg.bam"), str(d / "podg.fa")
    make_genome_workload(bam, fa, contigs=GENOME)
    single = run(bam, fa, str(d / "single"), _cfg(), device=CPU)
    jsingle = jax_run(bam, fa, str(d / "jsingle"), _jcfg())
    assert _read(single.vcf_path) == _read(jsingle.vcf_path)
    return dict(bam=bam, fa=fa, single=single, jsingle=jsingle)


@pytest.mark.parametrize("mode", ["--no-stream", "--stream"])
def test_two_process_pod_matches_single(tmp_path, genome, mode):
    """A real 2-process gloo pod through the CLI: process 0 writes the VCF
    bytes, phased-BAM payload and HP/PS tags of the single-process runs."""
    out = str(tmp_path / "pod")
    res = _pod(tmp_path, genome["bam"], genome["fa"], out, mode)
    for pid, (rc, so, se) in enumerate(res):
        assert rc == 0, se[-3000:]
        assert f"DONE {pid} 0" in so
    s0, s1 = _summary(res[0][1]), _summary(res[1][1])
    assert s0["process"] == 0 and s0["n_retried"] == 0
    assert s0.get("stream", False) == (mode == "--stream")
    assert s1["process"] == 1 and s1["n_regions_local"] > 0
    assert _read(out + ".vcf") == _read(genome["single"].vcf_path)
    assert (decompress_file(out + ".phased.bam")
            == decompress_file(genome["single"].phased_bam_path))
    assert _tags(out + ".phased.bam") == _tags(
        genome["jsingle"].phased_bam_path)


@pytest.mark.parametrize("gather_timeout", ["8", "0"])
def test_pod_survives_sigkilled_peer(tmp_path, gather_timeout):
    """Process 1 is SIGKILLed mid-shard. gloo fails process 0's gather at
    once (the peer's connection is gone) with or without a gather timeout:
    process 0 keeps its local results, retries the dead peer's regions,
    exits 0 and writes the single-process VCF."""
    bam, fa = str(tmp_path / "podk.bam"), str(tmp_path / "podk.fa")
    make_genome_workload(bam, fa, contigs=[("chrA", [(15_000, 40, 200)]),
                                           ("chrB", [(15_000, 60, 200)])])
    marker = str(tmp_path / "died.marker")
    out = str(tmp_path / "podk")
    res = _pod(tmp_path, bam, fa, out, "--no-stream", marker=marker,
               env={"LONGCALLR_GATHER_TIMEOUT": gather_timeout})
    assert res[1][0] == -9, (res[1][0], res[1][2][-500:])
    assert os.path.exists(marker)
    rc0, so0, se0 = res[0]
    assert rc0 == 0, se0[-3000:]
    assert "lost a peer" in se0
    assert _summary(so0)["n_retried"] > 0
    single = run(bam, fa, str(tmp_path / "singlek"), _cfg(), device=CPU)
    assert _read(out + ".vcf") == _read(single.vcf_path)
