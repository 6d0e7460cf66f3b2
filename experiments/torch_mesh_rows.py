"""The regions axis of the mesh on the cards, against the bucket it cuts.

    python3 experiments/torch_mesh_rows.py [out.json]

The deep workload (4 loci x 80 kb, 150x, 3 kb reads) as one wave, so its
four regions form one bucket, through ``caller.run(batched=True)`` with the
CLI's configuration for ``-t 8``, in one process, in the order none, cards,
repeat, repeat, cards, none:

* none   — no mesh: the bucket of four on the first card;
* cards  — ``make_mesh()``: every card of the process along "regions" (on
  four cards, one region a card; on one card, the bucket on that card);
* repeat — the first card four times along "regions": four rows of one
  region, one host thread each, on one card.

Each run's wall (host clock, ending in a synchronise), ``region_phase`` and
``phase_fused``, its kernel launches by card and by mesh row, and whether
its VCF bytes and phased-BAM payload equal the first run's; one JSON line
per run, then the cards' names and power limits and one summary line
(also written to out.json). Hosts differ between machines: compare only
within one call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

ORDER = ("none", "cards", "repeat", "repeat", "cards", "none")


def _payloads(prefix: str):
    from longcallr_tpu_torch.io.bgzf import decompress_file

    with open(prefix + ".vcf", "rb") as f:
        vcf = f.read()
    return vcf, bytes(decompress_file(prefix + ".phased.bam"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from longcallr_tpu_torch import _build, cli
    from longcallr_tpu_torch.parallel.mesh import make_mesh
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.pipeline.caller import run
    from longcallr_tpu_torch.utils import malloc_tune
    from longcallr_tpu_torch.utils.bench_workload import make_deep_workload
    from longcallr_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    _build.load()
    malloc_tune.tune()
    n_cards = torch.cuda.device_count()
    meshes = {"none": None, "cards": make_mesh(),
              "repeat": make_mesh(4, 1, [dev] * 4)}
    os.environ["LONGCALLR_WAVE_CELLS"] = str(1 << 40)     # one wave of 4
    rows, want = [], None
    with tempfile.TemporaryDirectory() as tmp:
        bam, fa = os.path.join(tmp, "deep.bam"), os.path.join(tmp, "deep.fa")
        params = make_deep_workload(bam, fa)
        for i, label in enumerate(ORDER):
            prefix = os.path.join(tmp, f"{i}_{label}")
            cfg = cli.config_from_args(cli.build_parser().parse_args(
                ["-b", bam, "-f", fa, "-o", prefix, "-p", "hifi-masseq",
                 "-t", "8"]))
            mesh = meshes[label]
            CK.reset_launches()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = run(bam, fa, prefix, cfg, batched=True, device=dev,
                      mesh=mesh)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            got = _payloads(prefix)
            want = want or got
            row = {"run": i, "label": label,
                   "mesh": None if mesh is None else list(mesh.shape),
                   "wall_seconds": wall,
                   "region_phase": out.stage_seconds.get("region_phase"),
                   "phase_fused": out.stage_seconds.get("phase_fused"),
                   "phase_buckets": out.stage_seconds.get("phase_buckets"),
                   "launches": dict(CK.LAUNCHES),
                   "launches_by_card": {str(k): v for k, v in
                                        CK.LAUNCHES_BY_DEVICE.items()},
                   "launches_by_row": {str(k): v for k, v in
                                       CK.LAUNCHES_BY_ROW.items()},
                   "bytes_equal": got == want}
            print(json.dumps(row), flush=True)
            rows.append(row)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print("\n".join(cards))
    summary = {"reads": params["n_reads"], "cards": n_cards,
               "card_names": cards, "runs": rows,
               "all_bytes_equal": all(r["bytes_equal"] for r in rows)}
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}))
    for a in sys.argv[1:]:
        with open(a, "w") as f:
            json.dump(summary, f, indent=1)
    return 0 if summary["all_bytes_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
