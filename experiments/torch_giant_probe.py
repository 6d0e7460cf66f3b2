"""Phase giant of chip_smoke.py alone, on one card, with the stream input cut
to its first contig (the phase reads only its first region):

    python3 experiments/torch_giant_probe.py [out.json]

Builds the kernels, then runs the exchange check, the bounded wait and the
whole phase; prints each step's JSON line and writes them to out.json."""

import json
import os
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main() -> int:
    out = sys.argv[1] if len(sys.argv) > 1 else None
    from longcallr_tpu_torch import _build
    from longcallr_tpu_torch.utils.bench_workload import make_genome_workload

    dev = torch.device("cuda", 0)
    card = C._card()
    for n in C.KERNEL_NAMES:     # phase kernels fills these in a full run
        C.KERNEL_STATS.setdefault(n, {"max_abs_err": 0.0, "max_rel_err": 0.0})
    lines, rc = [], 0
    t0 = time.monotonic()
    _build.load()
    lines.append({"step": "build", "seconds": time.monotonic() - t0})
    steps = [("exchange", lambda: C._exchange_kernel(dev, 512)),
             ("bounded_wait", C._bounded_wait)]
    with tempfile.TemporaryDirectory() as tmp:
        bam, fa = os.path.join(tmp, "s.bam"), os.path.join(tmp, "s.fa")
        make_genome_workload(bam, fa, contigs=[
            ("chr1", [(40_000, 120, 200)] * C.STREAM_LOCI)])
        steps.append(("giant", lambda: C.phase_giant(card, dev, tmp,
                                                     (bam, fa))))
        for name, fn in steps:
            t = time.monotonic()
            try:
                res = fn()
                lines.append({"step": name, "ok": True,
                              "seconds": time.monotonic() - t,
                              "result": res})
            except Exception as e:  # noqa: BLE001 - report every step
                rc = 1
                lines.append({"step": name, "ok": False,
                              "seconds": time.monotonic() - t,
                              "error": repr(e)[:2000],
                              "trace": traceback.format_exc()[-3000:]})
            print(json.dumps(lines[-1], default=str)[:3000], flush=True)
            if not lines[-1]["ok"] and name != "bounded_wait":
                break
    if out:
        with open(out, "w") as f:
            json.dump(lines, f, indent=1, default=str)
    print(card)
    return rc


if __name__ == "__main__":
    sys.exit(main())
