"""Smoke run of the torch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path (longcallr_tpu_torch; no JAX, nothing of the JAX
package) and fails on the first check that does not hold:

  1. build   — compiles the hand-written CUDA kernels from csrc/ (nvcc) and
               the host decoders from native/decode.cpp (g++);
  2. kernels — each kernel against its plain PyTorch version at the main
               path's shapes and at unaligned ones (max relative error
               <= 1e-12, two launches bit-identical); matvec_cols also with
               every third σ zero, with σ all zero, and on the scalar path
               (I not a multiple of 4; a table that is not 16-byte
               aligned); then 4 host threads call matvec_cols at once, two
               on the default stream and two on streams of their own.
               At the two main-path shapes, deep (1, 4096, 512) and
               enumeration (64, 512, 16, one shared Dp), each kernel is
               timed beside its plain version and the one library call
               that computes the same function (torch.matmul on the f64
               table, the widening not counted): the host time of a wrapper
               call and the median time of one call between CUDA events
               (both before the profiler first runs), then the device time
               per call from torch.profiler with the table warm in L2 and
               cold (256 MB written and read back between calls).
               The bound is the larger of bytes / 3.35 TB/s (each input
               read once, rows with σ = 0 not counted, the result written
               once) and f64 operations / 33.5 TFLOP/s (half the card's
               float32 rate outside the tensor cores);
  3. goldens — the four simulated preset workloads of the JAX package's
               golden tests through caller.run on the card, records and
               HP/PS tags byte-equal to tests/golden/preset_*;
  4. deep    — the deep workload (4 loci x 80 kb, 150x, 3 kb reads) through
               the CLI's main(); launch counts of both kernels are reset
               just before and read just after, and must be > 0;
  5. split vs f64 — the same input with LONGCALLR_F32_KERNELS=0 (f64 path
               on the card) must give byte-identical records and tags;
  6. imports — neither jax nor any longcallr_tpu module was imported.

Each phase prints one JSON line. Then the kernel summary line (``ms``,
``plain_ms`` and ``library_ms`` are device times per call with the table
warm in L2, at the deep shape), the card's name and power limit
(nvidia-smi), and last the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

REL_TOL = 1e-12
N_TIMED = 50
# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and f64 outside the tensor cores as half of the float32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 67e12 / 2
# written between two calls to push the table out of the 50 MB L2
FLUSH_BYTES = 256 << 20

# names of the kernels that flush the L2 between two timed calls
_FLUSH_KERNELS = ("FillFunctor", "Memset", "reduce_kernel")

DEEP = (1, 4096, 512, True)
ENUM = (64, 512, 16, True)
KERNEL_NAMES = ("dual_matvec_rows", "matvec_cols")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _emit(phase: str, card: str, **kw) -> None:
    print(json.dumps({"phase": phase, "card": card, **kw}), flush=True)


def _median_ms(fn, n: int = N_TIMED) -> float:
    """Median over n calls of the time between two CUDA events around one
    call: the device work and the host work of the call."""
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


def _host_ms(fn, n: int = 400) -> float:
    """Host time of one call (ms): n calls enqueued back to back, then one
    synchronise outside the timed span."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / n


def _device_ms(fn, flush=None, n: int = 20) -> float:
    """Device time per call (ms) from torch.profiler: the sum of every
    kernel's device time over n calls, divided by n. With ``flush`` (a
    buffer larger than the L2) the buffer is zeroed and summed before every
    call, so that the call finds its inputs in device memory, and the time
    of those two kernels is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if flush is not None:
                flush.zero_()       # written, then read back: the L2 ends
                flush.sum()         # up full of lines it can drop at once
            fn()
        torch.cuda.synchronize()
    # kernel rows only: an operator's row repeats its kernels' device time
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not any(w in e.key for w in _FLUSH_KERNELS))
    if not total_us > 0:
        raise AssertionError("torch.profiler reported no device time")
    return total_us / 1e3 / n


def _split_dp(rng, shape, dev, misalign: bool = False):
    dp = rng.normal(size=shape) * rng.integers(0, 2, size=shape)
    hi = dp.astype(np.float32)
    lo = (dp - hi.astype(np.float64)).astype(np.float32)
    if not misalign:
        return (torch.as_tensor(hi, device=dev),
                torch.as_tensor(lo, device=dev))
    # the same table one float past a 16-byte boundary
    out = []
    for a in (hi, lo):
        buf = torch.empty(a.size + 1, dtype=torch.float32, device=dev)
        buf[1:] = torch.as_tensor(a.reshape(-1), device=dev)
        out.append(buf[1:].view(*shape))
    return tuple(out)


def _check(name, row, kern, plain, hi, lo, op, stats):
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
    return {"max_abs_err": abs_err, "max_rel_err": rel}


def _bound(name: str, hi, op, out_numel: int):
    """(bound ms, bound by, bytes, f64 operations) of one call on these
    inputs: hi and lo read once (for matvec_cols only the rows some batch
    member's σ needs), the operand read once, the result written once; per
    cell one widening add and one multiply-add per operand column."""
    K, I = hi.shape[-2], hi.shape[-1]
    tables = hi.shape[0] if hi.dim() == 3 else 1
    B = op.shape[0] if op.dim() == (3 if name == "dual_matvec_rows" else 2) \
        else 1
    if name == "matvec_cols":
        s = op.reshape(-1, K)
        if tables == 1:
            rows = int((s != 0).any(dim=0).sum())
        else:
            rows = int((s != 0).sum())
        cells_read = rows * I
        cells_used = int((s != 0).sum()) * I
        flops = cells_used * 3
    else:
        cells_read = tables * K * I
        flops = B * K * I * 5
    nbytes = cells_read * 8 + op.numel() * 8 + out_numel * 8
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F64_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def _library_call(name, hi, lo, op):
    """The one PyTorch call that computes the same function: a matmul on
    the f64 table, which is widened here, outside what is timed."""
    dpd = hi.double() + lo.double()
    if name == "dual_matvec_rows":
        return lambda: torch.matmul(dpd, op)
    return lambda: torch.matmul(op, dpd)


def _time_host(name, kern, plain, hi, lo, op) -> dict:
    """Per-call times that include host work (ms). Taken before the
    profiler first runs in the process, so that no hook of it can sit in
    the launch path."""
    lib = _library_call(name, hi, lo, op)
    out, want = kern(hi, lo, op), lib()
    torch.cuda.synchronize()
    rel = float((out - want).abs().max()) / max(float(want.abs().max()), 1e-300)
    if not rel <= REL_TOL:
        raise AssertionError(f"{name}: library call differs by {rel}")
    k = lambda: kern(hi, lo, op)
    return {"wrapper_ms": _host_ms(k), "call_ms": _median_ms(k),
            "plain_call_ms": _median_ms(lambda: plain(hi, lo, op)),
            "library_call_ms": _median_ms(lib)}


def _time_device(name, kern, plain, hi, lo, op, flush) -> dict:
    """Device times of one kernel at one shape beside its bound (ms)."""
    lib = _library_call(name, hi, lo, op)
    bound_ms, bound_by, nbytes, flops = _bound(name, hi, op,
                                               kern(hi, lo, op).numel())
    k = lambda: kern(hi, lo, op)
    p = lambda: plain(hi, lo, op)
    t = {"ms": _device_ms(k), "cold_ms": _device_ms(k, flush),
         "plain_ms": _device_ms(p), "plain_cold_ms": _device_ms(p, flush),
         "library_ms": _device_ms(lib),
         "library_cold_ms": _device_ms(lib, flush),
         "bound_ms": bound_ms, "bound_by": bound_by, "bound_bytes": nbytes,
         "bound_f64_operations": flops}
    t["share_of_bound"] = bound_ms / t["ms"]
    t["share_of_bound_cold"] = bound_ms / t["cold_ms"]
    return t


def _threads_check(CK, rng, dev) -> dict:
    """4 host threads call matvec_cols at once on one card, each on its own
    input: threads 0 and 1 on the default stream (they share a workspace),
    2 and 3 on streams of their own. Every result must equal its plain
    version and the thread's first result bit for bit."""
    K, I, reps = 2048, 512, 40
    inputs = []
    for _ in range(4):
        hi, lo = _split_dp(rng, (K, I), dev)
        s = torch.as_tensor(rng.integers(-1, 2, size=K).astype(np.float64),
                            device=dev)
        inputs.append((hi, lo, s, CK.matvec_cols_plain(hi, lo, s)))
    torch.cuda.synchronize()
    errors = []
    start = threading.Barrier(4)

    def work(t: int) -> None:
        try:
            hi, lo, s, want = inputs[t]
            own = torch.cuda.Stream(dev) if t >= 2 else None
            with torch.cuda.stream(own):
                start.wait(timeout=60)
                outs = [CK.matvec_cols(hi, lo, s) for _ in range(reps)]
                torch.cuda.current_stream(dev).synchronize()
            scale = max(float(want.abs().max()), 1e-300)
            for o in outs:
                if not torch.equal(o, outs[0]):
                    raise AssertionError(f"thread {t}: launches differ")
            rel = float((outs[0] - want).abs().max()) / scale
            if not rel <= REL_TOL:
                raise AssertionError(f"thread {t}: relative error {rel}")
        except Exception as e:              # reported by the caller
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    if any(th.is_alive() for th in threads):
        raise AssertionError("matvec_cols threads did not finish")
    if errors:
        raise AssertionError("; ".join(errors))
    return {"threads": 4, "calls_each": reps, "K": K, "I": I,
            "workspaces": len(CK._WORKSPACES)}


def phase_kernels(card: str, dev):
    """Kernel vs plain at the listed shapes, the σ and alignment cases of
    matvec_cols, the threaded calls, and the timings at the two main-path
    shapes. Returns the summary stats by kernel name."""
    from longcallr_tpu_torch.phasing import cuda_kernels as CK

    rng = np.random.default_rng(20261016)
    kerns = {"dual_matvec_rows": (CK.dual_matvec_rows,
                                  CK.dual_matvec_rows_plain),
             "matvec_cols": (CK.matvec_cols, CK.matvec_cols_plain)}
    stats = {n: {"max_abs_err": 0.0, "max_rel_err": 0.0}
             for n in KERNEL_NAMES}
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    # (B, K, I, shared Dp) — the two main-path shapes first
    shapes = [DEEP, ENUM, (1, 37, 300, False), (1, 1025, 129, False),
              (1, 513, 700, False), (1, 4096, 510, False),
              (5, 300, 64, False)]
    rows, timed = [], []
    for B, K, I, shared in shapes:
        hl_shape = (K, I) if (shared or B == 1) else (B, K, I)
        hi, lo = _split_dp(rng, hl_shape, dev)
        xb = (B, I, 2) if B > 1 else (I, 2)
        sb = (B, K) if B > 1 else (K,)
        x = torch.as_tensor(rng.integers(-1, 2, size=xb).astype(np.float64),
                            device=dev)
        s = torch.as_tensor(rng.integers(-1, 2, size=sb).astype(np.float64),
                            device=dev)
        if (B, K, I, shared) == DEEP:
            # a deep region's σ: every read on a haplotype, the padded tail 0
            s = torch.as_tensor(rng.choice([-1.0, 1.0], size=K), device=dev)
            s[4000:] = 0.0
        row = {"B": B, "K": K, "I": I, "shared_dp": shared}
        for name, op in (("dual_matvec_rows", x), ("matvec_cols", s)):
            kern, plain = kerns[name]
            row[name] = _check(name, row, kern, plain, hi, lo, op, stats)
            if (B, K, I, shared) in (DEEP, ENUM):
                row[name].update(_time_host(name, kern, plain, hi, lo, op))
                key = "deep" if (B, K, I, shared) == DEEP else "enum"
                stats[name][key] = row[name]
                timed.append((name, row[name], hi, lo, op))
        rows.append(row)
    for name, res, hi, lo, op in timed:
        res.update(_time_device(name, *kerns[name], hi, lo, op, flush))

    # matvec_cols: σ patterns and the scalar path at the deep size
    kern, plain = kerns["matvec_cols"]
    hi, lo = _split_dp(rng, (4096, 512), dev)
    s_full = rng.choice([-1.0, 1.0], size=4096)
    s_third = s_full.copy()
    s_third[::3] = 0.0                      # every third read inactive
    cases = []
    for label, sv in (("third_zero", s_third),
                      ("all_zero", np.zeros(4096))):
        st = torch.as_tensor(sv, device=dev)
        res = _check("matvec_cols", label, kern, plain, hi, lo, st, stats)
        if label == "all_zero" and float(kern(hi, lo, st).abs().max()) != 0.0:
            raise AssertionError("matvec_cols: σ = 0 gave a non-zero result")
        b_ms, _, nbytes, _ = _bound("matvec_cols", hi, st, 512)
        res.update(case=label, bound_ms=b_ms, bound_bytes=nbytes,
                   ms=_device_ms(lambda: kern(hi, lo, st)),
                   cold_ms=_device_ms(lambda: kern(hi, lo, st), flush))
        cases.append(res)
    hi_m, lo_m = _split_dp(rng, (1024, 256), dev, misalign=True)
    if hi_m.data_ptr() % 16 == 0:
        raise AssertionError("the misaligned table is aligned")
    s_m = torch.as_tensor(rng.integers(-1, 2, size=1024).astype(np.float64),
                          device=dev)
    for name, op in (("matvec_cols", s_m), ("dual_matvec_rows", torch.as_tensor(
            rng.integers(-1, 2, size=(256, 2)).astype(np.float64),
            device=dev))):
        k2, p2 = kerns[name]
        res = _check(name, "misaligned", k2, p2, hi_m, lo_m, op, stats)
        res.update(case=f"misaligned_{name}")
        cases.append(res)

    threaded = _threads_check(CK, rng, dev)
    _emit("kernels", card, rel_tol=REL_TOL, shapes=rows, cols_cases=cases,
          threaded=threaded)
    return stats


def phase_goldens(card: str, dev, tmp: str) -> None:
    """The preset goldens through caller.run on ``dev``, byte for byte."""
    from longcallr_tpu_torch.config import preset
    from longcallr_tpu_torch.pipeline.caller import run
    from longcallr_tpu_torch.utils import demo, goldens

    done = []
    for name in goldens.GOLDEN_NAMES:
        t0 = time.monotonic()
        bam, fa, cfg, anno = goldens.golden_workload(name, tmp)
        out = run(bam, fa, os.path.join(tmp, f"out_{name}"), cfg,
                  anno_path=anno, device=dev)
        recs, tags = goldens.records_and_tags(out.vcf_path,
                                              out.phased_bam_path)
        want_recs, want_tags = goldens.golden(name)
        if recs != want_recs or tags != want_tags:
            raise AssertionError(f"golden {name}: records equal "
                                 f"{recs == want_recs}, tags equal "
                                 f"{tags == want_tags}")
        done.append({"workload": name, "records": len(recs),
                     "tags": len(tags), "byte_equal": True,
                     "seconds": time.monotonic() - t0})

    if not os.path.exists(demo.DEMO_BAM):
        done.append({"workload": "demo_chr20", "skipped": True,
                     "reason": "LONGCALLR_DEMO_BAM names no file"})
        _emit("goldens", card, workloads=done)
        return
    ref_fa = os.path.join(tmp, "demo_chr20_consensus.fa")
    demo.make_consensus_reference(demo.DEMO_BAM, ref_fa)
    out = run(demo.DEMO_BAM, ref_fa, os.path.join(tmp, "demo"),
              preset("hifi-masseq").replace(threads=2), device=dev)
    recs, tags = goldens.records_and_tags(out.vcf_path, out.phased_bam_path)
    base = os.path.join(goldens.GOLDEN_DIR, "demo_chr20")
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
    from longcallr_tpu_torch import cli
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.utils.bench_workload import make_deep_workload

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
    from longcallr_tpu_torch.utils.goldens import records_and_tags

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


def phase_imports(card: str) -> None:
    """The run imported neither jax nor any module of the JAX package."""
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "jaxlib", "longcallr_tpu")
                 or m.startswith(("jax.", "jaxlib.", "longcallr_tpu.")))
    if bad:
        raise AssertionError(f"imported: {bad[:8]}")
    _emit("imports", card, jax=False, longcallr_tpu=False)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from longcallr_tpu_torch import _build, native
    from longcallr_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = _card()
    t0 = time.monotonic()
    _build.load()
    t1 = time.monotonic()
    if not native.available():
        raise AssertionError("native/decode.cpp did not build")
    _emit("build", card, nvcc_seconds=t1 - t0,
          gxx_seconds=time.monotonic() - t1)
    stats = phase_kernels(card, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_goldens(card, dev, tmp)
        bam, fa, out, launches = phase_deep(card, tmp)
        phase_split_vs_f64(card, tmp, bam, fa, out)
    phase_imports(card)
    replaces = {
        "dual_matvec_rows": "longcallr_tpu/phasing/pallas_kernels.py:190",
        "matvec_cols": "longcallr_tpu/phasing/pallas_kernels.py:230",
    }
    kernels = []
    for n in KERNEL_NAMES:
        deep, enum = stats[n]["deep"], stats[n]["enum"]
        k = {"name": n, "route": "cuda",
             "source": "longcallr_tpu_torch/csrc/split_matvec.cu",
             "replaces": replaces[n], "launches": launches[n],
             "max_abs_err": stats[n]["max_abs_err"], "shape": list(DEEP[:3])}
        k.update({f: deep[f] for f in deep if f.endswith("ms")
                  or f.startswith(("bound", "share"))})
        k["enum_shape"] = list(ENUM[:3])
        k["enum"] = {f: enum[f] for f in enum if f.endswith("ms")
                     or f.startswith(("bound", "share"))}
        kernels.append(k)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
