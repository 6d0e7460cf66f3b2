"""The deep workload through the CLI of two checkouts on one card, in turns.

    python3 experiments/torch_deep_ab.py LABEL=DIR LABEL=DIR [out.json]

Each DIR holds a checkout of the repository (``.`` for this one; unpack
another commit with ``git archive`` into a git-ignored directory). The deep
workload (4 loci x 80 kb, 150x, 3 kb reads) is generated once. Each checkout
first builds its kernels and host decoders, then the checkouts run in the
order A, B, B, A, each time the per-region loop (``--no-batched``), the
default batched pipeline and the batched pipeline with the four regions in
one wave (``MODES``), every run a fresh process with the checkout as its
working directory: the wall of ``cli.main`` (process start and builds not
counted) and its stage seconds. One JSON line per run; the card's name and
power limit on the last line. Hosts differ between machines by up to 2x:
compare only within one call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

_RUN = """
import json, sys, time
from longcallr_tpu_torch import cli
t0 = time.monotonic()
rc = cli.main(sys.argv[1:])
wall = time.monotonic() - t0
print("AB_JSON " + json.dumps({"rc": rc, "wall_seconds": wall,
                               "stage_seconds": cli.LAST_RUN.stage_seconds}))
"""
# (label, CLI arguments, environment): the per-region loop, the default
# batched pipeline (two waves of two regions) and the four regions as one
# wave
MODES = (("per_region", ["--no-batched"], {}),
         ("batched", [], {}),
         ("one_wave", [], {"LONGCALLR_WAVE_CELLS": str(1 << 40)}))
_BUILD = ("from longcallr_tpu_torch import _build, native; _build.load(); "
          "assert native.available()")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from longcallr_tpu_torch.utils.bench_workload import make_deep_workload

    trees = [a.split("=", 1) for a in sys.argv[1:] if "=" in a]
    out_json = [a for a in sys.argv[1:] if "=" not in a]
    if len(trees) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [(label, os.path.abspath(d)) for label, d in trees]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        bam, fa = os.path.join(tmp, "deep.bam"), os.path.join(tmp, "deep.fa")
        params = make_deep_workload(bam, fa)
        for label, d in trees:
            subprocess.run([sys.executable, "-c", _BUILD], cwd=d, check=True)
        n = 0
        for label, d in (trees[0], trees[1], trees[1], trees[0]):
            for mode, extra, env in MODES:
                n += 1
                res = subprocess.run(
                    [sys.executable, "-c", _RUN, "-b", bam, "-f", fa, "-o",
                     os.path.join(tmp, f"out{n}"), "-p", "hifi-masseq",
                     "--platform", "cuda", *extra],
                    cwd=d, capture_output=True, text=True, timeout=900,
                    env={**os.environ, **env})
                if res.returncode != 0:
                    raise AssertionError(f"{label} {mode}: exit "
                                         f"{res.returncode}\n"
                                         f"{res.stderr[-2000:]}")
                got = json.loads([l for l in res.stdout.splitlines()
                                  if l.startswith("AB_JSON ")][-1][8:])
                st = got["stage_seconds"]
                row = {"tree": label, "mode": mode,
                       "reads": params["n_reads"],
                       "wall_seconds": got["wall_seconds"],
                       "region_phase": st.get("region_phase"),
                       "phase_fused": st.get("phase_fused"),
                       "regions_pipeline": st.get("regions_pipeline"),
                       "phased_bam": st.get("phased_bam")}
                rows.append(row)
                print(json.dumps(row), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if out_json:
        with open(out_json[0], "w") as f:
            json.dump({"card": card, "runs": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
