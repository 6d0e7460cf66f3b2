"""One run of one cell: set-up, a measured window of whole passes of the
program's CLI, the check of what the passes wrote against the reference,
and the result line.

A pass is one call of ``longcallr_tpu_torch.cli.main`` over the whole
input, as a user runs it. The set-up warms the process up with one pass
over the input's first contig. The window closes at the end of the first
pass that ends at or after ``--seconds``, and holds ``MIN_PASSES`` passes
at the least; it is the passes' time alone: the
harness moves each pass's outputs aside between passes, outside the clock,
and reads them after the window. The traced run profiles the device
activity of the first pass of its window (CUDA activity only); the spans
and counters come from the passes after the one that follows it.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Dict, List, Optional

from reference import config as RC

from . import check, manifest
from . import trace as T
from .rss import RssPeak

FORBIDDEN = ("jax", "jaxlib", "flax", "longcallr_tpu")
# regions of a run that the reference calls at the least (one of every
# class of size, and more drawn to make up this many)
SAMPLE_REGIONS = 8
MIB = float(1 << 20)
# passes a window holds at the least: the device memory the process holds
# grows over its first passes (state the program keeps per thread) and is
# steady from the fourth on, so the window's peak is the steady one; a
# traced window also keeps two passes after the profiled one and the next
MIN_PASSES = 4


def process_age() -> float:
    """Seconds since this process started (the kernel's clock ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that no run may load."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


def _outputs_bytes(prefix: str) -> int:
    d, base = os.path.split(prefix)
    return sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d)
               if n.startswith(base + "."))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Pass:
    """What the harness keeps of one pass: the program's stage seconds, the
    change of its device-program counters, and its device memory."""

    def __init__(self, stage: Dict[str, float], graphs: Dict[str, float],
                 reads: int, seconds: float = 0.0, profiled: bool = False):
        self.stage, self.graphs, self.reads = stage, graphs, reads
        self.seconds, self.profiled = seconds, profiled
        self.device_peak = self.device_held = 0     # bytes


def calm_passes(passes: List[Pass]) -> List[Pass]:
    """The passes that the profiler left alone, whose spans and counters
    the per-layer metrics read: not a profiled pass, nor the one after it,
    which its end slows."""
    return [p for i, p in enumerate(passes)
            if not p.profiled and not (i and passes[i - 1].profiled)]


def run(workload: str, seed: int, seconds: float, trace: bool,
        platform: str = "cuda", control: bool = False,
        workdir: Optional[str] = None) -> Dict:
    """One run; returns the result line as a dict (``check`` last).
    ``control`` puts in the program's place the reference with one
    guarantee of the configuration broken, its preset's strand-bias filter
    switched (on where the preset has it off, off where on), and runs no
    pass: its result has to come out not correct."""
    bench = manifest.load()
    cell = manifest.workload(bench, workload)
    cfg = manifest.config(bench, cell["config"])

    # the program builds its CUDA library and native/decode.cpp in
    # longcallr_tpu_torch/build/ and native/build/, inside the checkout, so
    # only a checkout's first run compiles
    t0 = time.monotonic()
    import torch
    from longcallr_tpu_torch import cli, native
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    cuda = platform == "cuda"
    if cuda:
        torch.zeros(1, device="cuda")
        _log(f"card: {_power_limit()}")
    t_import = time.monotonic()
    if cuda:
        from longcallr_tpu_torch import _build
        _build.load()
    native.lib()
    t_libs = time.monotonic()

    # under the run's TMPDIR, or inside the checkout where there is none
    work = workdir or os.path.join(
        os.environ.get("TMPDIR") or os.path.join(manifest.ROOT, ".perfbench_tmp"),
        "perfbench", f"{workload}-{seed}")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    gen = subprocess.run(
        [sys.executable, os.path.join(manifest.PERFBENCH, "harness", "generate.py"),
         json.dumps(manifest.traffic(cell["traffic"])), str(seed), work],
        capture_output=True, text=True)
    if gen.returncode != 0:
        raise RuntimeError(f"input generation failed:\n{gen.stderr[-4000:]}")
    counts = json.loads(gen.stdout.strip().splitlines()[-1])
    written = sum(os.path.getsize(os.path.join(work, n)) for n in os.listdir(work))
    t_gen = time.monotonic()

    if control:
        regions, (calls, ctl), bam = check.reference_calls(
            os.path.join(work, "in.bam"), os.path.join(work, "in.fa"),
            cfg["preset"], seed, SAMPLE_REGIONS, os.cpu_count() or 1,
            ({}, {"strand_bias": not RC.preset(cfg["preset"]).strand_bias}))
        shutil.rmtree(work, ignore_errors=True)
        numbers = check.compare_calls(calls, ctl, bam)
        return {"correct": all(numbers[k] <= check.LIMITS[k] for k in numbers),
                "attempted": 0, "failed": 0, "metrics": {},
                "device": {"platform": platform, "count": cell["chips"]},
                "check": {k: {"value": v, "limit": check.LIMITS[k]}
                          for k, v in numbers.items()}}

    prefix = os.path.join(work, "out")
    flags = ["-f", os.path.join(work, "in.fa"), "-p", cfg["preset"],
             "-t", str(cfg["threads"]), "--platform", platform] + list(cfg["flags"])
    argv = ["-b", os.path.join(work, "in.bam"), "-o", prefix] + flags
    with open(os.path.join(work, "in.fa.fai")) as f:
        first_contig = f.readline().split("\t")[0]
    warm_argv = ["-b", os.path.join(work, "in.bam"), "-o",
                 os.path.join(work, "warm"), "-x", first_contig] + flags

    def one_pass(args=argv) -> Pass:
        g0 = dict(CK.GRAPHS)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(args)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.monotonic() - t
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc}")
        graphs = {k: CK.GRAPHS[k] - g0[k] for k in g0}
        p = Pass(dict(cli.LAST_RUN.stage_seconds), graphs, counts["n_reads"],
                 seconds)
        if cuda:
            p.device_peak = torch.cuda.max_memory_allocated()
            p.device_held = torch.cuda.memory_allocated()
        return p

    # warm-up, counted as set-up: one pass over the first contig, which
    # loads what a process loads once (CUDA, cuBLAS, the allocator's pools,
    # lazily imported modules); the program frees its device programs at
    # the end of every pass, so a longer warm-up keeps nothing more
    warm = one_pass(warm_argv)
    written += _outputs_bytes(os.path.join(work, "warm"))
    t_warm = time.monotonic()
    _log(f"set-up: import and card {t_import - t0:.3f} s, libraries "
         f"{t_libs - t_import:.3f} s, input {t_gen - t_libs:.3f} s, warm-up "
         f"pass over {first_contig} {t_warm - t_gen:.3f} s")

    passes: List[Pass] = []
    kept = os.path.join(work, "passes")
    os.makedirs(kept)
    profiled = None
    profile_tries = 0
    window = 0.0
    setup_s = process_age()
    with RssPeak() as rss:
        while True:
            if trace and profiled is None and profile_tries < 3:
                profile_tries += 1
                p, profiled = _profiled_pass(one_pass, torch)
                p.profiled = True
            else:
                p = one_pass()
            passes.append(p)
            window += p.seconds
            # outside the clock: the outputs move aside (a rename, no copy)
            written += _outputs_bytes(prefix)
            for ext in (".vcf", ".phased.bam"):
                os.replace(prefix + ext, os.path.join(kept, f"{len(passes)}{ext}"))
            if window >= seconds and len(passes) >= MIN_PASSES:
                break
    # the peak stats are reset at each pass's start, so the window's peak
    # is the largest of its passes'
    peak = max(p.device_peak for p in passes)
    if trace and profiled is None:
        raise RuntimeError("the profiler saw no kernel in three passes")
    _log(f"window: {len(passes)} passes in {window:.3f} s; the warm-up's "
         f"{warm.seconds:.3f} s; disk written {written} bytes (input and "
         f"every pass's outputs)")
    for i, p in enumerate(passes):
        _log(f"pass {i + 1}: {p.seconds:.3f} s" + (" (profiled)" if p.profiled else "")
             + "; " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(p.stage.items())
                                if k.startswith(("region_", "phased_bam", "bam_")))
             + f"; builds {p.graphs['builds']}; device peak "
             f"{p.device_peak / MIB:.2f} MiB, {p.device_held / MIB:.2f} MiB held "
             "after it")

    cli.LAST_RUN = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    digests = [check.pass_digest(os.path.join(kept, str(i + 1)))
               for i in range(len(passes))]
    t_digests = time.monotonic()
    regions, (calls,), bam = check.reference_calls(
        os.path.join(work, "in.bam"), os.path.join(work, "in.fa"),
        cfg["preset"], seed, SAMPLE_REGIONS, os.cpu_count() or 1)
    numbers = check.compare(os.path.join(kept, str(len(passes))), digests,
                            regions, calls, bam)
    _log(f"outputs of {len(passes)} passes read in {t_digests - t_ref:.3f} s; "
         f"reference: {len(calls)} of {len(regions)} regions in "
         f"{time.monotonic() - t_digests:.3f} s")
    shutil.rmtree(work, ignore_errors=True)

    reads = sum(p.reads for p in passes)
    e2e = {"reads_per_s": reads / window,
           "device_peak_mib": peak / MIB,
           "host_peak_rss_mib": rss.peak / MIB,
           "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in manifest.metrics(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = {"passes": calm_passes(passes), "trace": profiled,
               "workload": workload}
        for m in manifest.metrics(bench, workload, "per_layer"):
            v = manifest.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": all(numbers[k] <= check.LIMITS[k] for k in numbers),
              "attempted": len(passes), "failed": 0, "metrics": metrics,
              "device": device}
    if trace:
        device.update(busy_s=profiled["busy_s"], window_s=profiled["span_s"])
        ops = sorted(profiled["by_name"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in ops],
                               "idle_gaps": profiled["gaps"]}
    result["check"] = {k: {"value": v, "limit": check.LIMITS[k]}
                       for k, v in numbers.items()}
    return result


def _profiled_pass(one_pass, torch):
    """A pass under ``torch.profiler`` (CUDA activity only), bracketed by a
    marker operation on each side; (the pass, the reduced trace or None
    where the profiler saw no device activity inside the markers)."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.fill_(1.0)
        p = one_pass()
        marker.fill_(2.0)
        torch.cuda.synchronize()
    intervals = T.device_intervals(prof)
    if len(intervals) <= 2:
        return p, None
    return p, T.reduce(intervals)
