"""Frozen reference digests of the JAX package's output on the bench inputs.

    JAX_PLATFORMS=cpu python experiments/reference_digests.py [--no-stream]
        [--only LABEL ...]

Runs the JAX package (``longcallr_tpu``, the reference) on the CPU backend
through its CLI, one fresh process per run, on the inputs that
``chip_smoke.py`` drives on the card: the deep workload
(``make_deep_workload`` defaults) at the default waves and as one wave of 4
(``LONGCALLR_WAVE_CELLS`` = 2^40), the genome workload
(``make_genome_workload`` defaults), the stream input (5 contigs of 13
loci of 40 kb at 120x, resident, 8 threads) and the enumeration inputs of
``longcallr_tpu_torch/utils/goldens.ENUM_INPUTS`` ("enum", "enum_deep" and
"transcriptome", 8 threads). Each run writes its VCF and
phased BAM with the hifi-masseq preset, and the script writes to
``tests/golden/reference_digests.json``, per input: the SHA-256 of the VCF
record lines (header left out) and of the sorted "qname HP PS" lines of the
phased BAM's tagged reads (``utils/goldens.digests`` computes the same for
the port), their counts, and the seconds the run took. ``--no-stream``
leaves the stream input out (its run is the longest); ``--only`` runs the
inputs named and keeps every other entry of the file as it is; where a run
fails or times out its entry says so, with its seconds.

The inputs are generated with the JAX package's own generator, whose copy
in the port makes the same bytes (tests/test_torch_host_copies.py).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "tests", "golden", "reference_digests.json")
STREAM_SPEC = [(f"chr{i + 1}", [(40_000, 120, 200)] * 13) for i in range(5)]
ONE_WAVE = {"LONGCALLR_WAVE_CELLS": str(1 << 40)}
TIMEOUT = 3 * 3600


def digests(vcf_path: str, bam_path: str) -> dict:
    """SHA-256 of the VCF record lines and of the sorted tag lines."""
    from longcallr_tpu.io.bam import BamFile

    with open(vcf_path) as f:
        records = [l for l in f if not l.startswith("#")]
    pb = BamFile(bam_path)
    tags = []
    for i in range(pb.n_records):
        r = pb.read(i)
        hp = r.get_tag("HP")
        if hp is not None:
            tags.append(f"{r.qname}\t{hp}\t{r.get_tag('PS')}\n")
    tags.sort()
    sha = lambda lines: hashlib.sha256("".join(lines).encode()).hexdigest()
    return {"records_sha256": sha(records), "tags_sha256": sha(tags),
            "n_records": len(records), "n_tagged": len(tags)}


def _run(tmp: str, label: str, bam: str, fa: str, extra=(), env=None) -> dict:
    prefix = os.path.join(tmp, label)
    cmd = [sys.executable, "-m", "longcallr_tpu.cli", "-b", bam, "-f", fa,
           "-o", prefix, "-p", "hifi-masseq", *extra]
    t0 = time.monotonic()
    try:
        res = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                             timeout=TIMEOUT,
                             env={**os.environ, "JAX_PLATFORMS": "cpu",
                                  **(env or {})})
    except subprocess.TimeoutExpired:
        return {"ok": False, "seconds": time.monotonic() - t0,
                "error": f"timed out after {TIMEOUT} s"}
    secs = time.monotonic() - t0
    if res.returncode != 0:
        return {"ok": False, "seconds": secs,
                "error": res.stderr[-2000:]}
    return {"ok": True, "seconds": secs,
            **digests(prefix + ".vcf", prefix + ".phased.bam")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-stream", action="store_true")
    ap.add_argument("--only", nargs="+", metavar="LABEL")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from longcallr_tpu.utils.bench_workload import (make_deep_workload,
                                                     make_genome_workload)
    from longcallr_tpu_torch.utils.goldens import ENUM_INPUTS

    out = {"reference": "longcallr_tpu CLI, JAX CPU backend, -p hifi-masseq",
           "script": "experiments/reference_digests.py", "inputs": {}}
    if args.only:
        with open(OUT) as f:
            out = json.load(f)
    # label → (generator keyword arguments, CLI arguments, environment)
    inputs = {"deep": ({}, (), None), "deep_one_wave": ({}, (), ONE_WAVE),
              "genome": ({}, (), None)}
    if not args.no_stream:
        inputs["stream"] = (dict(contigs=STREAM_SPEC),
                            ("--no-stream", "-t", "8"), None)
    for label, kw in ENUM_INPUTS.items():
        inputs[label] = (kw, ("-t", "8"), None)
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda n: os.path.join(tmp, n)
        for label in args.only or list(inputs):
            kw, extra, env = inputs[label]
            name = "deep" if label.startswith("deep") else label
            bam, fa = p(f"{name}.bam"), p(f"{name}.fa")
            if name == "deep":
                make_deep_workload(bam, fa)
            else:
                make_genome_workload(bam, fa, **kw)
            out["inputs"][label] = _run(tmp, label, bam, fa, extra, env)
            print(label, json.dumps(out["inputs"][label]), flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
