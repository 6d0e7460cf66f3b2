"""Where does the host beat the card? The sweep behind the placement
thresholds of ``longcallr_tpu_torch/utils/device.py``.

    python3 experiments/torch_placement_sweep.py [out.json] [--quick]

Needs one CUDA card (it fails without one). For regions simulated by
``make_genome_workload`` and prepared by the port's own pileup, candidate
and fragment stages it times ``optimize.phase_region_on``

  * on the card in split mode, safety net included (what a region placed on
    the card costs a run), and
  * on the host in f64 (what the same region costs when placed there),

warm (one untimed call first), median of 5 calls (where the untimed call
took more than 20 s it is the measurement, and the row says ``n`` = 0):

  * enumeration regions of 4, 6 and 10 SNPs at about 64 and 512 reads
    (work = 2^I0 · K · I_pad),
  * iterative regions with K · I_pad from 2^12 to 2^24
    (work = K · I_pad · (I0 // 4 + 1)),

buckets of four iterative regions of 2^12 to 2^18 cells each
(``batch_driver.phase_regions_batched`` on the card against the four
members one by one on the host; work = 4 · K · I_pad · (I0 // 4 + 1)),

and ``candidates.candidate_kernel`` (transfer in and out included) over
padded column counts from 2^10 to 2^20 (cells = Ppad · 16). It prints one
JSON line per row, then per family the crossing point: the work (or cells)
from which the card wins at every larger measured size, interpolated on the
log of the size between the last host win and the first card win; 0 when
the card never loses. The card's name and power limit go on every line.
``--quick`` stops the iterative family at 2^20 and the candidates at 2^16.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from longcallr_tpu_torch.config import preset  # noqa: E402
from longcallr_tpu_torch.io.bam import BamFile  # noqa: E402
from longcallr_tpu_torch.io.fasta import FastaFile  # noqa: E402
from longcallr_tpu_torch.ops import candidates as C  # noqa: E402
from longcallr_tpu_torch.phasing import batch_driver as BD  # noqa: E402
from longcallr_tpu_torch.phasing import optimize as O  # noqa: E402
from longcallr_tpu_torch.pipeline.engine import (  # noqa: E402
    prepare_region, prepare_region_pileup)
from longcallr_tpu_torch.tiles.regions import (  # noqa: E402
    extract_isolated_regions_parallel)
from longcallr_tpu_torch.utils.bench_workload import (  # noqa: E402
    make_genome_workload)
from longcallr_tpu_torch.utils import device as D  # noqa: E402
from longcallr_tpu_torch.utils.device import resolve_device  # noqa: E402

N_TIMED = 5
SLOW_S = 20.0
CPU = torch.device("cpu")

# (label, locus length, coverage, SNP spacing, read length): one locus each
ENUM = [("enum4_k64", 4_000, 40, 900, 3_000),
        ("enum6_k64", 5_400, 30, 900, 3_000),
        ("enum10_k64", 6_400, 28, 600, 3_000),
        ("enum4_k512", 4_000, 340, 900, 3_000),
        ("enum6_k512", 5_400, 240, 900, 3_000),
        ("enum10_k512", 9_000, 170, 900, 3_000)]
ITER = [("iter_2^12", 2_800, 90, 200, 1_000),
        ("iter_2^14", 6_000, 83, 200, 1_000),
        ("iter_2^16", 12_400, 242, 200, 3_000),
        ("iter_2^18", 25_200, 238, 200, 3_000),
        ("iter_2^20", 50_400, 238, 200, 3_000),
        ("iter_2^22", 100_400, 239, 200, 3_000),
        ("iter_2^24", 200_400, 240, 200, 3_000)]


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _timed(fn, sync) -> dict:
    """Warm median seconds of fn: one untimed call, then N_TIMED timed ones.
    Where the untimed call took more than SLOW_S it is the measurement
    (n = 0). ``result`` is the last call's."""
    t0 = time.perf_counter()
    result = fn()
    sync()
    first = time.perf_counter() - t0
    times = []
    for _ in range(0 if first > SLOW_S else N_TIMED):
        t0 = time.perf_counter()
        result = fn()
        sync()
        times.append(time.perf_counter() - t0)
    return {"seconds": float(np.median(times)) if times else first,
            "first_seconds": first, "n": len(times),
            "min": min(times, default=first),
            "max": max(times, default=first), "result": result}


def _locus(tmp: str, spec, dev):
    """One simulated locus through the port's prepare stages: (cfg, cands,
    frags, apply_ds, seed, pileup)."""
    label, length, cov, spacing, read_len = spec
    bam_p = os.path.join(tmp, f"{label}.bam")
    fa_p = os.path.join(tmp, f"{label}.fa")
    make_genome_workload(bam_p, fa_p, read_len=read_len,
                         contigs=[("chrP", [(length, cov, spacing)])])
    cfg = preset("hifi-masseq").replace(threads=4)
    bam, fasta = BamFile(bam_p, threads=4), FastaFile(fa_p)
    regions = extract_isolated_regions_parallel(bam, fasta.contig_lengths,
                                                cfg)
    reg = max(regions, key=lambda r: r.length)
    ref = fasta.fetch(reg.chr)
    cands, frags, apply_ds = prepare_region(bam, reg, ref, cfg, dev)
    pileup = prepare_region_pileup(bam, reg, ref, cfg)
    return cfg, cands, frags, apply_ds, reg.start, pileup


def _phase_row(tmp: str, spec, dev, card: str) -> dict:
    cfg, cands, frags, apply_ds, seed, _ = _locus(tmp, spec, dev)
    K0, I0 = frags.p.shape
    K, I_pad = O._bucket(max(1, K0)), O._bucket(max(1, I0))
    enum = I0 <= cfg.max_enum_snps
    work = ((1 << I0) * K * I_pad if enum else K * I_pad * (I0 // 4 + 1))
    reruns0 = O.N_F64_RERUNS
    on_card = _timed(lambda: O.phase_region_on(frags, cands, cfg, seed,
                                               apply_ds, dev, True),
                     torch.cuda.synchronize)
    reruns = (O.N_F64_RERUNS - reruns0) / (on_card["n"] + 1)
    on_host = _timed(lambda: O.phase_region_on(frags, cands, cfg, seed,
                                               apply_ds, CPU, False),
                     lambda: None)
    same = all(np.array_equal(x, y) for x, y in
               zip(on_card.pop("result"), on_host.pop("result")))
    row = {"family": "enum" if enum else "iter", "label": spec[0],
           "K0": K0, "I0": I0, "K": K, "I_pad": I_pad, "size": work,
           "card_s": on_card["seconds"], "host_s": on_host["seconds"],
           "card": on_card, "host": on_host,
           "f64_reruns_per_card_call": reruns, "states_equal": same,
           "card_name": card}
    print(json.dumps(row), flush=True)
    if not same:
        raise AssertionError(f"{spec[0]}: the card's state differs from the "
                             f"host's")
    return row


def _bucket_row(tmp: str, spec, dev, card: str, B: int = 4) -> dict:
    """A bucket of B copies of one iterative region (each with its own
    seed): ``phase_regions_batched`` on the card against the B members one
    by one on the host, which is where a bucket below the threshold goes."""
    cfg, cands, frags, apply_ds, seed, _ = _locus(tmp, spec, dev)
    K0, I0 = frags.p.shape
    K, I_pad = O._bucket(max(1, K0)), O._bucket(max(1, I0))
    items = [(frags, cands, seed + b, apply_ds) for b in range(B)]
    saved, D.MIN_ACCEL_PHASE_WORK = D.MIN_ACCEL_PHASE_WORK, 0
    try:
        on_card = _timed(lambda: BD.phase_regions_batched(items, cfg,
                                                          device=dev),
                         torch.cuda.synchronize)
    finally:
        D.MIN_ACCEL_PHASE_WORK = saved
    on_host = _timed(lambda: [O.phase_region_on(f, c, cfg, s, a, CPU, False)
                              for f, c, s, a in items], lambda: None)
    same = all(np.array_equal(x, y)
               for m, n in zip(on_card.pop("result"), on_host.pop("result"))
               for x, y in zip(m, n))
    row = {"family": "bucket", "label": f"{B}x_{spec[0]}", "B": B, "K0": K0,
           "I0": I0, "K": K, "I_pad": I_pad,
           "size": B * K * I_pad * (I0 // 4 + 1),
           "card_s": on_card["seconds"], "host_s": on_host["seconds"],
           "card": on_card, "host": on_host, "states_equal": same,
           "card_name": card}
    print(json.dumps(row), flush=True)
    if not same:
        raise AssertionError(f"{row['label']}: the card's states differ from "
                             f"the host's")
    return row


def _candidate_rows(tmp: str, dev, card: str, max_log2: int) -> list:
    cfg, _, _, _, _, pileup = _locus(tmp, ITER[3], dev)
    base = C._kernel_cols(pileup, None)
    rows = []
    for lg in range(10, max_log2 + 1, 2):
        Ppad = 1 << lg
        cols = {k: np.resize(v, (Ppad,) + v.shape[1:])
                for k, v in base.items()}

        def call(d):
            out = C.candidate_kernel(C._to_device(cols, d), cfg)
            return {k: v.cpu().numpy() for k, v in out.items()}

        on_card = _timed(lambda: call(dev), torch.cuda.synchronize)
        on_host = _timed(lambda: call(CPU), lambda: None)
        a, b = on_card.pop("result"), on_host.pop("result")
        row = {"family": "candidates", "label": f"Ppad_2^{lg}", "Ppad": Ppad,
               "size": Ppad * 16, "card_s": on_card["seconds"],
               "host_s": on_host["seconds"], "card": on_card,
               "host": on_host,
               "category_equal": bool(np.array_equal(a["category"],
                                                     b["category"])),
               "card_name": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def crossing(rows) -> dict:
    """The size from which the card wins at every larger measured size."""
    rows = sorted(rows, key=lambda r: r["size"])
    last_host = -1
    for i, r in enumerate(rows):
        if r["host_s"] <= r["card_s"]:
            last_host = i
    if last_host < 0:
        return {"crossing": 0, "card_never_loses": True}
    if last_host == len(rows) - 1:
        return {"crossing": None, "host_wins_at_largest": rows[-1]["size"]}
    lo, hi = rows[last_host], rows[last_host + 1]
    # log(card/host) is positive at lo, negative at hi: its zero between
    f = lambda r: math.log(r["card_s"] / r["host_s"])
    t = f(lo) / (f(lo) - f(hi))
    x = math.log2(lo["size"]) + t * (math.log2(hi["size"])
                                     - math.log2(lo["size"]))
    return {"crossing": int(round(2 ** x)), "crossing_log2": x,
            "last_host_win": lo["size"], "first_card_win": hi["size"]}


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    quick = "--quick" in sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_placement_sweep: no CUDA device available",
              file=sys.stderr)
        return 1
    dev = resolve_device("cuda")
    card = _card()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for spec in ENUM + (ITER[:5] if quick else ITER):
            rows.append(_phase_row(tmp, spec, dev, card))
        for spec in ITER[:4]:
            rows.append(_bucket_row(tmp, spec, dev, card))
        rows += _candidate_rows(tmp, dev, card, 16 if quick else 20)
    summary = {"card": card, "torch": torch.__version__,
               "host_threads": torch.get_num_threads()}
    for fam in ("enum", "iter", "bucket", "candidates"):
        summary[fam] = crossing([r for r in rows if r["family"] == fam])
    print(json.dumps({"crossings": summary}), flush=True)
    if args:
        os.makedirs(os.path.dirname(os.path.abspath(args[0])), exist_ok=True)
        with open(args[0], "w") as f:
            json.dump({"rows": rows, "crossings": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
