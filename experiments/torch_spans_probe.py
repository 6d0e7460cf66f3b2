"""The port's spans on the benchmark's cell, read on the card: what the
benchmark's traced run cannot read yet (``perfbench/harness/spans.py``).

    python3 experiments/torch_spans_probe.py OUT.json [--workload masseq-transcriptome]
        [--seed N] [--pairs 2] [--platform cpu --traffic JSON]

Makes the cell's input from ``--seed`` as ``perfbench/run.py`` does, warms
the process up with a pass over the first contig, then runs whole passes
of the CLI with span recording off and on in turns (off, on, on, off, ...
``--pairs`` times): the reads per second of each, for the cost of the
recording, and from each recorded pass the span metrics (the main thread's
waits, the region stages' wall and thread CPU seconds, the phase's host
placements and f64 reruns, the device programs' runs, and how much of the
region pipeline the main thread's waits and finalize cover; on the card
also each pass's peak of device memory and the device programs it built,
``graphs.BUILDS``: key and bytes held; after each pass the process's
resident set and its high-water mark). Last, one
pass with recording on under ``torch.profiler`` (CUDA activity only, with
the harness's markers): the ten longest idle gaps labelled with the host's
part and the share of the idle device time inside the phase worker's
spans. Writes OUT.json; prints a summary. ``--platform cpu`` with a small
``--traffic`` (a traffic file's JSON) rehearses it on the host, without
the profiled pass and without a number worth keeping.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [os.path.join(ROOT, "perfbench"), ROOT]

from harness import manifest  # noqa: E402
from harness import spans as HS  # noqa: E402
from harness import trace as T  # noqa: E402

REGION = ("region.pileup", "region.fragments", "region.assign",
          "region.records")
MAIN = ("caller.wait_phase", "caller.wait_prepare", "caller.finalize")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip()


def _metrics(p: dict, recs) -> dict:
    """The span metrics of one recorded pass."""
    pipe = p["stage"]["regions_pipeline"]
    n = lambda name: sum(1 for s in recs if s.name == name)
    return {
        "caller.wait_phase_s": HS.span_seconds(recs, ("caller.wait_phase",),
                                               "main"),
        "caller.wait_prepare_s": HS.span_seconds(
            recs, ("caller.wait_prepare",), "main"),
        "caller.finalize_s": HS.span_seconds(recs, ("caller.finalize",),
                                             "main"),
        **{f"{k}_s": p["stage"]["region_" + k.split(".")[1]] for k in REGION},
        "region.host_cpu_s": sum(p["stage"]["region_" + k.split(".")[1]]
                                 for k in REGION),
        "region.host_thread_cpu_s": HS.span_seconds(recs, REGION, cpu=True),
        "phase.region_phase_s": p["stage"]["region_phase"],
        "phase.host_placed_s": HS.span_seconds(recs, ("phase.host_placed",)),
        "phase.card_f64_placed_s": HS.span_seconds(
            recs, ("phase.card_f64_placed",)),
        **{f"count.{k}": p["stage"].get(k, 0) for k in (
            "phase_host_placed", "phase_card_placed", "phase_card_f64_placed",
            "phase_enum_buckets", "phase_single_regions",
            "phase_safety_recompute")},
        "phase.single_region_s": HS.span_seconds(
            recs, ("phase.single_region",)),
        "phase.enum_bucket_s": HS.span_seconds(recs, ("phase.enum_bucket",)),
        "phase.keep_best_s": HS.span_seconds(recs, ("phase.keep_best",)),
        "phase.f64_rerun_s": HS.span_seconds(recs, ("phase.f64_rerun",)),
        "phase.f64_reruns": n("phase.f64_rerun"),
        "phase.wave_phase_s": HS.span_seconds(recs, ("caller.phase",),
                                              "phase"),
        "prep.prepare_s": HS.span_seconds(recs, ("caller.prepare",), "prep"),
        "programs.run_s": HS.span_seconds(recs, ("programs.run",)),
        "programs.lock_wait_s": HS.span_seconds(recs,
                                                ("programs.lock_wait",)),
        "programs.run_seconds_counter": p["graphs"].get("run_seconds"),
        "main_cover_of_regions_pipeline": HS.covered(recs, MAIN, "main")
        / pipe,
        "regions_pipeline_s": pipe,
        "n_spans": len(recs),
    }


def _rss_mib() -> dict:
    """The process's resident set now and its high-water mark, MiB."""
    out = {}
    with open("/proc/self/status") as f:
        for line in f:
            key, _, val = line.partition(":")
            if key in ("VmRSS", "VmHWM"):
                out[key.lower() + "_mib"] = int(val.split()[0]) / 1024
    return out


def _self_by_name(recs, role: str, top: int = 12) -> list:
    """The names whose spans' own time on ``role``'s threads is largest."""
    from longcallr_tpu_torch.utils.spans import self_ns

    own = self_ns(recs)
    by: dict = {}
    for s in recs:
        if s.role == role:
            by[s.name] = by.get(s.name, 0) + own[s.id]
    return sorted(([k, v * 1e-9] for k, v in by.items()),
                  key=lambda kv: -kv[1])[:top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--workload", default="masseq-transcriptome")
    ap.add_argument("--seed", type=int, default=3141592653)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--platform", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--traffic", default=None)
    args = ap.parse_args(argv)
    cuda = args.platform == "cuda"

    import torch

    from longcallr_tpu_torch import _build, cli, native
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import graphs as G
    from longcallr_tpu_torch.utils import spans

    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    cfg = manifest.config(bench, cell["config"])
    if cuda:
        torch.zeros(1, device="cuda")
        _build.load()
    native.lib()
    traffic = (json.loads(args.traffic) if args.traffic
               else manifest.traffic(cell["traffic"]))
    work = tempfile.mkdtemp(prefix="spans_probe_")
    gen = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "harness",
                                      "generate.py"),
         json.dumps(traffic), str(args.seed), work],
        capture_output=True, text=True, check=True)
    counts = json.loads(gen.stdout.strip().splitlines()[-1])
    flags = ["-f", os.path.join(work, "in.fa"), "-p", cfg["preset"], "-t",
             str(cfg["threads"]), "--platform", args.platform] + list(
                 cfg["flags"])
    with open(os.path.join(work, "in.fa.fai")) as f:
        first = f.readline().split("\t")[0]

    def one_pass(record: bool, prefix: str = "out", contig=None) -> tuple:
        argv = ["-b", os.path.join(work, "in.bam"), "-o",
                os.path.join(work, prefix)] + flags
        if contig:
            argv += ["-x", contig]
        g0 = dict(CK.GRAPHS)
        G.reset_builds()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if record:
            spans.enable()
        t = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv)
        if cuda:
            torch.cuda.synchronize()
        seconds = time.monotonic() - t
        recs = spans.drain() if record else []
        spans.disable()
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc}")
        p = {"seconds": seconds, "reads_per_s": counts["n_reads"] / seconds,
             "record": record, "stage": dict(cli.LAST_RUN.stage_seconds),
             "graphs": {k: CK.GRAPHS[k] - g0[k] for k in g0},
             "builds": [dict(b) for b in G.BUILDS]}
        if cuda:
            p["device_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        p.update(_rss_mib())
        return p, recs

    one_pass(False, "warm", first)
    passes = []
    for _ in range(args.pairs):
        for record in (False, True, True, False):
            p, recs = one_pass(record)
            if record:
                p["metrics"] = _metrics(p, recs)
                p["phase_self"] = _self_by_name(recs, "phase")
                p["main_self"] = _self_by_name(recs, "main")
                p["prep_self"] = _self_by_name(recs, "prep")
            passes.append(p)
            print(json.dumps({
                **{k: p[k] for k in ("seconds", "reads_per_s", "record")},
                "device_peak_mib": p.get("device_peak_mib"),
                **_rss_mib(),
                "builds": len(p["builds"]),
                "bytes_held": sum(b["bytes_held"] for b in p["builds"])}),
                flush=True)

    on = [p["reads_per_s"] for p in passes if p["record"]]
    off = [p["reads_per_s"] for p in passes if not p["record"]]
    result = {"card": _card() if cuda else "cpu", "seed": args.seed,
              "n_reads": counts["n_reads"], "reads_per_s_off": off,
              "reads_per_s_on": on, "passes": passes,
              "profiled": _profiled_pass(work, flags) if cuda else None}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    shutil.rmtree(work, ignore_errors=True)
    pr = result["profiled"] or {}
    print(json.dumps({"card": result["card"], "off": off, "on": on,
                      "idle_pct": pr.get("idle_pct"),
                      "idle_in_phase_pct": pr.get("device.idle_in_phase_pct"),
                      "gaps": [g[0][:64] for g in pr.get("gaps_labelled", [])],
                      "metrics": [p["metrics"] for p in passes
                                  if p["record"]][-1]}, indent=1))
    return 0


def _profiled_pass(work: str, flags: list) -> dict:
    """One pass with recording on under torch.profiler (CUDA activity
    only), bracketed by a marker operation on each side as the harness
    brackets its profiled pass: the gaps, labelled and plain, and the idle
    device time inside the phase worker's and the main thread's spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from longcallr_tpu_torch import cli
    from longcallr_tpu_torch.utils import spans

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    spans.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.fill_(1.0)
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["-b", os.path.join(work, "in.bam"), "-o",
                      os.path.join(work, "prof")] + flags)
        marker.fill_(2.0)
        torch.cuda.synchronize()
    recs = spans.drain()
    spans.disable()
    intervals = T.device_intervals(prof)
    red = T.reduce(intervals)
    ivs = HS.on_trace(recs, spans.profiler_start_ns(prof), spans.unix_ns)
    hit, idle = HS.idle_inside(intervals, ivs, "caller.phase", "phase")
    hit_wait, _ = HS.idle_inside(intervals, ivs, "caller.wait_phase", "main")
    return {
        "busy_s": red["busy_s"], "span_s": red["span_s"],
        "idle_pct": 100.0 * (1.0 - red["busy_s"] / red["span_s"]),
        "device.idle_in_phase_pct": 100.0 * hit / idle,
        "idle_in_main_wait_phase_pct": 100.0 * hit_wait / idle,
        "gaps_plain": red["gaps"],
        "gaps_labelled": HS.label_gaps(intervals, ivs),
        "n_spans": len(recs), "n_device_ops": len(intervals)}


if __name__ == "__main__":
    sys.exit(main())
