"""The keep-best kernel on the card, and the launches a pass of the
benchmark's cell makes with the enumeration waves.

    python3 experiments/torch_enum_wave_probe.py OUT.json [--seed N]

1. ``phasing/cuda_keep_best.keep_best`` against its plain version at C
   objectives (4, 64, 1,024, 4,099: ties inside, at and just above TIE_TOL),
   bit for bit; then timed: the kernel's device time per launch from
   torch.profiler over 200 launches, the time of a launch between CUDA
   events over 2,000 launches one after another, the plain version's host
   time, and the bound: 8·C + 32 bytes (the objectives and the running
   best read once, best and index written once) over 3.35 TB/s.
2. The cell ``masseq-transcriptome``'s input from ``--seed`` (as
   ``perfbench/run.py`` makes it), one CLI pass to warm up and one
   counted: the hand kernels' launches (the matvec kernels, the keep-best,
   the set-condition kernel), the device programs' counters and the phase's
   stage counts.

Writes OUT.json and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

HBM = 3.35e12


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return out.stdout.strip()


def _probs(rng, C: int):
    import numpy as np
    from longcallr_tpu_torch.phasing.kernels import TIE_TOL

    base = np.round(rng.normal(-40.0, 3.0, C), 1)
    at = rng.integers(0, C, max(1, C // 3))
    base[at] += rng.choice([0.0, TIE_TOL / 2, TIE_TOL, TIE_TOL * 1.0001],
                           at.size)
    return base


def kernel_rows(dev) -> list:
    import numpy as np
    import torch
    from longcallr_tpu_torch.phasing import cuda_keep_best as KB
    from longcallr_tpu_torch.phasing.kernels import TIE_TOL

    rng = np.random.default_rng(20261018)
    rows = []
    for C in (4, 64, 1024, 4099):
        host = torch.tensor(_probs(rng, C), dtype=torch.float64)
        prev = torch.tensor(-np.inf, dtype=torch.float64)
        p, v = host.to(dev), prev.to(dev)
        want = KB.keep_best_plain(host, prev, TIE_TOL)
        got = KB.keep_best(p, v, TIE_TOL)
        torch.cuda.synchronize()
        if not (torch.equal(got[0].cpu(), want[0])
                and torch.equal(got[1].cpu(), want[1])):
            raise AssertionError(f"keep_best differs at C={C}: {got} {want}")
        out = (torch.empty((), dtype=torch.float64, device=dev),
               torch.empty((), dtype=torch.int64, device=dev))
        for _ in range(50):
            KB.keep_best(p, v, TIE_TOL, out=out)
        n = 2000
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(n):
            KB.keep_best(p, v, TIE_TOL, out=out)
        b.record()
        b.synchronize()
        events_ms = a.elapsed_time(b) / n
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(200):
                KB.keep_best(p, v, TIE_TOL, out=out)
            torch.cuda.synchronize()
        dev_us = [e.device_time_total / e.count for e in prof.key_averages()
                  if "keep_best_kernel" in e.key]
        t0 = time.perf_counter()
        for _ in range(200):
            KB.keep_best_plain(host, prev, TIE_TOL)
        plain_ms = (time.perf_counter() - t0) * 1e3 / 200
        rows.append({"C": C, "equal": True,
                     "kernel_ms": dev_us[0] / 1e3 if dev_us else None,
                     "launch_ms_events": events_ms, "plain_ms_host": plain_ms,
                     "bound_ms": (8 * C + 32) / HBM * 1e3})
    return rows


def cell_pass(seed: int) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "perfbench"))
    from harness import manifest

    from longcallr_tpu_torch import cli
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing.cuda_keep_best import KEEP_BEST_LAUNCHES

    bench = manifest.load()
    cell = manifest.workload(bench, "masseq-transcriptome")
    cfg = manifest.config(bench, cell["config"])
    with tempfile.TemporaryDirectory() as work:
        gen = subprocess.run(
            [sys.executable, os.path.join(manifest.PERFBENCH, "harness",
                                          "generate.py"),
             json.dumps(manifest.traffic(cell["traffic"])), str(seed), work],
            capture_output=True, text=True)
        if gen.returncode != 0:
            raise RuntimeError(gen.stderr[-4000:])
        argv = ["-b", os.path.join(work, "in.bam"), "-f",
                os.path.join(work, "in.fa"), "-p", cfg["preset"], "-t",
                str(cfg["threads"]), "--platform", "cuda"]
        res = {}
        for label in ("warm", "counted"):
            CK.reset_launches()
            t0 = time.monotonic()
            rc = cli.main(argv + ["-o", os.path.join(work, label)])
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            st = cli.LAST_RUN.stage_seconds
            res[label] = {
                "wall_s": time.monotonic() - t0,
                "launches": dict(CK.LAUNCHES),
                "keep_best": KEEP_BEST_LAUNCHES["keep_best"],
                "programs": dict(CK.GRAPHS),
                "region_phase_s": st.get("region_phase"),
                "counts": {k: st.get(k) for k in (
                    "phase_enum_wave_syncs", "phase_enum_wave_regions",
                    "phase_card_f64_placed", "phase_card_placed",
                    "phase_host_placed", "phase_enum_buckets",
                    "phase_single_regions", "phase_safety_recompute")}}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=2147483725)
    args = ap.parse_args(argv)
    import torch
    from longcallr_tpu_torch import _build
    from longcallr_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    _build.load()
    out = {"card": _card(), "torch": torch.__version__,
           "kernel": kernel_rows(dev),
           "cell_pass": cell_pass(args.seed)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
