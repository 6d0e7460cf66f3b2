"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path (longcallr_tpu_torch; no JAX) and fails on the
first check that does not hold:

  1. build   — compiles the hand-written CUDA kernels from csrc/;
  2. kernels — each kernel against its plain PyTorch version at the main
               path's shapes (max relative error <= 1e-12, two launches
               bit-identical), with the median time per call over 50 calls
               (CUDA events; includes the wrapper's host work) and the
               device time per call (torch.profiler);
  3. goldens — the four simulated preset workloads of the JAX package's
               golden tests through caller.run on the card, records and
               HP/PS tags byte-equal to tests/golden/preset_*;
  4. deep    — the deep workload (4 loci x 80 kb, 150x, 3 kb reads) through
               the CLI's main(); launch counts of both kernels are reset
               just before and read just after, and must be > 0;
  5. split vs f64 — the same input with LONGCALLR_F32_KERNELS=0 (f64 path
               on the card) must give byte-identical records and tags.

Each phase prints one JSON line. Then the kernel summary line, the card's
name and power limit (nvidia-smi), and last the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

REL_TOL = 1e-12
N_TIMED = 50


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _emit(phase: str, card: str, **kw) -> None:
    print(json.dumps({"phase": phase, "card": card, **kw}), flush=True)


def _median_ms(fn, n: int = N_TIMED) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _device_ms(fn, n: int = 20):
    """Device time per call (ms) from torch.profiler: the sum of every
    kernel's device time over n calls, divided by n. None when the profiler
    reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / 1e3 / n if total_us > 0 else None


def _split_dp(rng, shape, dev):
    dp = rng.normal(size=shape) * rng.integers(0, 2, size=shape)
    hi = dp.astype(np.float32)
    lo = (dp - hi.astype(np.float64)).astype(np.float32)
    return (torch.as_tensor(hi, device=dev), torch.as_tensor(lo, device=dev))


def phase_kernels(card: str, dev):
    """Kernel vs plain at the listed shapes. Returns the summary stats."""
    from longcallr_tpu_torch.phasing import cuda_kernels as CK

    rng = np.random.default_rng(20261016)
    # (B, K, I, shared Dp) — the deep main-path shape first
    shapes = [(1, 4096, 512, False), (64, 512, 16, True),
              (1, 37, 300, False), (1, 1025, 129, False),
              (1, 513, 700, False)]
    stats = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0}
             for n in ("dual_matvec_rows", "matvec_cols")}
    rows = []
    for B, K, I, shared in shapes:
        hl_shape = (K, I) if (shared or B == 1) else (B, K, I)
        hi, lo = _split_dp(rng, hl_shape, dev)
        xb = (B, I, 2) if B > 1 else (I, 2)
        sb = (B, K) if B > 1 else (K,)
        x = torch.as_tensor(rng.integers(-1, 2, size=xb).astype(np.float64),
                            device=dev)
        s = torch.as_tensor(rng.integers(-1, 2, size=sb).astype(np.float64),
                            device=dev)
        row = {"B": B, "K": K, "I": I, "shared_dp": shared}
        for name, kern, plain, op in (
                ("dual_matvec_rows", CK.dual_matvec_rows,
                 CK.dual_matvec_rows_plain, x),
                ("matvec_cols", CK.matvec_cols, CK.matvec_cols_plain, s)):
            got = kern(hi, lo, op)
            again = kern(hi, lo, op)
            want = plain(hi, lo, op)
            torch.cuda.synchronize()
            if got.shape != want.shape:
                raise AssertionError(f"{name} {row}: shape {tuple(got.shape)}"
                                     f" != {tuple(want.shape)}")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} {row}: two launches differ")
            abs_err = float((got - want).abs().max())
            rel = abs_err / max(float(want.abs().max()), 1e-300)
            if not rel <= REL_TOL:
                raise AssertionError(f"{name} {row}: relative error {rel} "
                                     f"> {REL_TOL}")
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], abs_err)
            st["max_rel_err"] = max(st["max_rel_err"], rel)
            ms = _median_ms(lambda: kern(hi, lo, op))
            plain_ms = _median_ms(lambda: plain(hi, lo, op))
            dev_ms = _device_ms(lambda: kern(hi, lo, op))
            plain_dev_ms = _device_ms(lambda: plain(hi, lo, op))
            row[name] = {"max_abs_err": abs_err, "max_rel_err": rel,
                         "ms": ms, "plain_ms": plain_ms,
                         "device_ms": dev_ms, "plain_device_ms": plain_dev_ms}
            if (B, K, I) == (1, 4096, 512):
                st.update(ms=ms, plain_ms=plain_ms, device_ms=dev_ms,
                          plain_device_ms=plain_dev_ms)
        rows.append(row)
    _emit("kernels", card, rel_tol=REL_TOL, shapes=rows)
    return stats


GOLDEN_NAMES = ("ont-cdna", "ont-drna", "hifi-isoseq", "exon_only")
_GOLDEN_SEEDS = {"ont-cdna": 101, "ont-drna": 102, "hifi-isoseq": 103,
                 "exon_only": 104}
_EXON_GTF = ('chrS\tsrc\tgene\t1\t6000\t.\t+\t.\tgene_id "G1";\n'
             'chrS\tsrc\tCDS\t400\t2600\t.\t+\t.\tgene_id "G1";\n'
             'chrS\tsrc\tCDS\t3200\t5400\t.\t+\t.\tgene_id "G1";\n')


def golden_workload(name: str, tmp: str):
    """One simulated workload of tests/test_golden_presets.py, rebuilt with
    the same seeds and calls (that module imports the JAX caller).
    Returns (bam, fasta, cfg, annotation or None)."""
    from longcallr_tpu.config import preset
    from simulate import make_reference, plant_snps, simulate_bam

    rng = np.random.default_rng(_GOLDEN_SEEDS[name])
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=10, n_hom=2, min_gap=400)
    bam = os.path.join(tmp, f"{name}.bam")
    if name == "exon_only":
        simulate_bam(bam, rng, ref, truth, n_reads=90, read_len=2500,
                     err_rate=0.01)
        anno = os.path.join(tmp, "exon.gtf")
        with open(anno, "w") as f:
            f.write(_EXON_GTF)
        return (bam, bam[:-4] + ".fa",
                preset("hifi-masseq").replace(threads=2, exon_only=True),
                anno)
    # a single-strand artifact site away from the planted SNPs
    planted = sorted(set(truth.het_snps) | set(truth.hom_snps))
    site = 4400
    while any(abs(site - q) < 150 for q in planted):
        site += 37
    alt = int(b"ACGT"[(b"ACGT".index(bytes([int(ref[site])])) + 2) % 4])
    simulate_bam(bam, rng, ref, truth, n_reads=90, read_len=2500,
                 err_rate=0.01, biased_sites={site: alt})
    return bam, bam[:-4] + ".fa", preset(name).replace(threads=2), None


def records_and_tags(vcf_path: str, bam_path: str):
    """(VCF record lines, sorted "qname HP PS" lines of the phased BAM)."""
    from longcallr_tpu.io.bam import BamFile

    with open(vcf_path) as f:
        records = [l for l in f if not l.startswith("#")]
    rows = []
    pb = BamFile(bam_path)
    for i in range(pb.n_records):
        r = pb.read(i)
        hp = r.get_tag("HP")
        if hp is not None:
            rows.append(f"{r.qname}\t{hp}\t{r.get_tag('PS')}\n")
    rows.sort()
    return records, rows


def golden(tag: str):
    """The frozen (records, tags) of tests/golden/preset_<tag>_*."""
    base = os.path.join(HERE, "tests", "golden", f"preset_{tag}")
    with open(base + "_records.vcf") as f:
        recs = f.readlines()
    with open(base + "_tags.tsv") as f:
        tags = f.readlines()
    return recs, tags


def phase_goldens(card: str, dev, tmp: str) -> None:
    """The preset goldens through caller.run on ``dev``, byte for byte."""
    from longcallr_tpu.config import preset
    from longcallr_tpu_torch.pipeline.caller import run

    done = []
    for name in GOLDEN_NAMES:
        t0 = time.monotonic()
        bam, fa, cfg, anno = golden_workload(name, tmp)
        out = run(bam, fa, os.path.join(tmp, f"out_{name}"), cfg,
                  anno_path=anno, device=dev)
        recs, tags = records_and_tags(out.vcf_path, out.phased_bam_path)
        want_recs, want_tags = golden(name)
        if recs != want_recs or tags != want_tags:
            raise AssertionError(f"golden {name}: records equal "
                                 f"{recs == want_recs}, tags equal "
                                 f"{tags == want_tags}")
        done.append({"workload": name, "records": len(recs),
                     "tags": len(tags), "byte_equal": True,
                     "seconds": time.monotonic() - t0})

    from longcallr_tpu.utils.demo import DEMO_BAM as demo
    if not os.path.exists(demo):
        done.append({"workload": "demo_chr20", "skipped": True,
                     "reason": f"{demo} not present"})
        _emit("goldens", card, workloads=done)
        return
    from longcallr_tpu.utils.demo import make_consensus_reference
    ref_fa = os.path.join(tmp, "demo_chr20_consensus.fa")
    make_consensus_reference(demo, ref_fa)
    out = run(demo, ref_fa, os.path.join(tmp, "demo"),
              preset("hifi-masseq").replace(threads=2), device=dev)
    recs, tags = records_and_tags(out.vcf_path, out.phased_bam_path)
    base = os.path.join(HERE, "tests", "golden", "demo_chr20")
    with open(base + "_records.vcf") as f:
        want_recs = f.readlines()
    with open(base + "_tags.tsv") as f:
        want_tags = [l + "\n" for l in f.read().splitlines()]
    if recs != want_recs or tags != want_tags:
        raise AssertionError("golden demo_chr20 differs")
    done.append({"workload": "demo_chr20", "records": len(recs),
                 "byte_equal": True})
    _emit("goldens", card, workloads=done)


def phase_deep(card: str, tmp: str):
    """The deep workload through the CLI's main() on the card."""
    from longcallr_tpu.utils.bench_workload import make_deep_workload
    from longcallr_tpu_torch import cli
    from longcallr_tpu_torch.phasing import cuda_kernels as CK

    bam = os.path.join(tmp, "deep.bam")
    fa = os.path.join(tmp, "deep.fa")
    t0 = time.monotonic()
    params = make_deep_workload(bam, fa)
    gen_s = time.monotonic() - t0
    prefix = os.path.join(tmp, "deep_split")
    argv = ["-b", bam, "-f", fa, "-o", prefix, "-p", "hifi-masseq",
            "--platform", "cuda"]
    CK.reset_launches()
    t0 = time.monotonic()
    rc = cli.main(argv)
    wall = time.monotonic() - t0
    launches = dict(CK.LAUNCHES)
    out = cli.LAST_RUN
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"main path")
    if out.n_records <= 0:
        raise AssertionError("deep run wrote no records")
    if out.n_split_kept <= 0:
        raise AssertionError("every region needed the f64 rerun")
    _emit("deep", card, reads=params["n_reads"], regions=out.n_regions,
          records=out.n_records, phased_sites=out.n_phased_sites,
          generate_seconds=gen_s, wall_seconds=wall,
          reads_per_second=params["n_reads"] / wall,
          stage_seconds=out.stage_seconds, launches=launches,
          split_regions_kept=out.n_split_kept,
          f64_reruns=out.n_f64_reruns)
    return bam, fa, out, launches


def phase_split_vs_f64(card: str, tmp: str, bam: str, fa: str, split_out):
    """The deep input again with LONGCALLR_F32_KERNELS=0 (f64 on the card)
    in a fresh process; outputs must be byte-identical."""
    prefix = os.path.join(tmp, "deep_f64")
    env = dict(os.environ, LONGCALLR_F32_KERNELS="0")
    t0 = time.monotonic()
    res = subprocess.run(
        [sys.executable, "-m", "longcallr_tpu_torch.cli", "-b", bam, "-f", fa,
         "-o", prefix, "-p", "hifi-masseq", "--platform", "cuda"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=900)
    wall = time.monotonic() - t0
    if res.returncode != 0:
        raise AssertionError(f"f64 run failed ({res.returncode}):\n"
                             f"{res.stderr[-3000:]}")
    a = records_and_tags(split_out.vcf_path, split_out.phased_bam_path)
    b = records_and_tags(prefix + ".vcf", prefix + ".phased.bam")
    if a != b:
        raise AssertionError(f"split vs f64: records equal {a[0] == b[0]}, "
                             f"tags equal {a[1] == b[1]}")
    stages = [l.strip() for l in res.stdout.splitlines()
              if l.strip().startswith("stage ")]
    _emit("split_vs_f64", card, byte_equal=True, records=len(a[0]),
          tags=len(a[1]), f64_wall_seconds=wall, f64_stages=stages)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "tests"))  # simulate.py (jax-free)
    from longcallr_tpu_torch import _build
    from longcallr_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = _card()
    t0 = time.monotonic()
    _build.load()
    _emit("build", card, seconds=time.monotonic() - t0)
    stats = phase_kernels(card, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_goldens(card, dev, tmp)
        bam, fa, out, launches = phase_deep(card, tmp)
        phase_split_vs_f64(card, tmp, bam, fa, out)
    replaces = {
        "dual_matvec_rows": "longcallr_tpu/phasing/pallas_kernels.py:190",
        "matvec_cols": "longcallr_tpu/phasing/pallas_kernels.py:230",
    }
    kernels = [{"name": n, "route": "cuda",
                "source": "longcallr_tpu_torch/csrc/split_matvec.cu",
                "replaces": replaces[n], "launches": launches[n],
                "max_abs_err": stats[n]["max_abs_err"],
                "ms": stats[n]["ms"], "plain_ms": stats[n]["plain_ms"],
                "device_ms": stats[n]["device_ms"],
                "plain_device_ms": stats[n]["plain_device_ms"]}
               for n in ("dual_matvec_rows", "matvec_cols")]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
