"""Time the cols kernels' launch shapes and variants on a CUDA card.

    python3 experiments/torch_cols_variants.py [out.json] [--walk-only]
        [--no-sweep] [--one-member] [--parts] [--rates]

At the shapes where members share a table (tables, K, I; members per table),
among them the enumeration shapes the main path launches, and at one member
per table with I <= 32, it times (device time per call in torch.profiler,
warm, and cold after 256 MB written and read back):

  * the walk (``cols_walk_kernel``) as ``cols_walk_plan`` plans it, and with
    other columns per thread, members per block, ways and stage tiles;
  * the strip (``cols_kernel``) as ``cols_plan`` plans it, the design that
    served these shapes before the walk;
  * one torch.bmm on the f64 tables (the library call).

``--one-member`` times only the shapes of one member per table (the walk's
direct form beside the strip); ``--no-sweep`` times the planned walk and, at
one member per table, the direct form's other launch shapes.

Each walk launch is first held against the plain version (1e-12 relative),
against a second launch and, for members at both ends of a table, against the
member alone on its table (bit for bit).

At the deep main-path shape (K=4096, I=512, σ = ±1 with the padded tail of 96
rows zero) it times, by kernel name in torch.profiler (device time per launch,
table warm in L2, and cold after a 256 MB fill that leaves the L2 full of
written lines, which the launch must first push out: an upper bound of the
cold time; chip_smoke.py also reads the buffer back and sees less):

  * the kernel of longcallr_tpu_torch/csrc/split_matvec.cu at several launch
    shapes (column threads per block, rows per block);
  * the two variants of csrc/tune/cols_variants.cu: rows staged through shared
    memory with cp.async, and unconditional loads that do not wait for σ;
  * the parts of the kernel's time: an empty kernel of the same grid, the row
    stream without ticket and combine, and both with σ = 0 (no row read).

Every result is first held against the plain version (1e-12 relative). One
JSON line per timing; the card's name and power limit on the last line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)

from longcallr_tpu_torch import _build  # noqa: E402
from longcallr_tpu_torch.phasing import cuda_kernels as CK  # noqa: E402

K, I = 4096, 512


def build_variants() -> ctypes.CDLL:
    src = os.path.join(_build.SRC_DIR, "tune", "cols_variants.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, f"libcols_variants_{os.getpid()}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.cols_variant.restype = i
    lib.cols_variant.argtypes = [i, vp, vp, ll, vp, vp, vp, vp, i, i, i, i, i,
                                 vp]
    return lib


def device_us(fn, match: str, flush=None, n: int = 30) -> float:
    """Mean device time (µs) of the kernels whose name contains ``match``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if match in e.key]
    if not hits:
        raise AssertionError(f"no kernel named *{match}* in "
                             f"{[e.key[:60] for e in prof.key_averages()]}")
    return sum(e.self_device_time_total for e in hits) / sum(
        e.count for e in hits)


# (tables, K, I, members per table): the enumeration shapes the main path
# launches, then one member per table at I <= 32 (iterative regions of 11 to
# 32 SNPs), which the walk serves too
WALK_SHAPES = [(4, 512, 16, 512), (1, 1024, 16, 1024), (6, 1024, 16, 128),
               (1, 64, 8, 8), (12, 64, 8, 16), (4, 512, 8, 64),
               (1, 512, 16, 1024), (64, 8, 16, 1024), (1, 1024, 16, 1),
               (4, 1024, 16, 1), (1, 4096, 16, 1), (5, 2048, 32, 1),
               (1, 2048, 16, 1), (5, 4096, 16, 1), (1, 4096, 32, 1),
               (3, 512, 32, 1), (1, 512, 8, 1), (1, 512, 8, 64),
               (1, 64, 8, 16)]
_FLUSH_KERNELS = ("FillFunctor", "Memset", "at::native::reduce_kernel")
# staged walk variants timed a shape, at most
WALK_SAMPLE = 30


def call_us(fn, match, flush=None, n: int = 20) -> float:
    """Device time (µs) per call of the kernels whose name contains
    ``match`` (None: every kernel but the flush's), the flush written and
    read back before each call where it is given."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(6):        # a profile now and then traces no kernel
        time.sleep(0.2 * attempt)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if flush is not None:
                    flush.zero_()
                    flush.sum()
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and (match in e.key if match else
                     not any(w in e.key for w in _FLUSH_KERNELS))]
        if hits:
            return sum(e.self_device_time_total for e in hits) / n
    raise AssertionError(f"no kernel named {match} was traced")


def walk_variants(plan, I, K, g):
    """Other launch shapes of the walk around the planned one: columns and
    members per thread, members per block (half, twice), ways, tiles a
    stage and stage buffers; and the direct form with as many ways as fit,
    in clusters of 1 to 16."""
    per_tile = CK.COLS_WALK_TILE // CK.COLS_WALK_CHAIN
    chains = -(-K // CK.COLS_WALK_CHAIN)
    mb = plan[2]
    ok = []
    for v in (1, 2):
        if I % v:
            continue
        cg = I // v
        for cl in (1, 2, 4, 8, 16):
            ways = min(-(-chains // (cl * per_tile)) * per_tile,
                       CK.COLS_WALK_THREADS // cg // per_tile * per_tile)
            while (ways > per_tile and CK.cols_walk_shared_bytes(
                    K, I, 1, ways, 1, 1) > CK.MAX_DYN_SHARED):
                ways -= per_tile
            if ways >= per_tile:
                ok.append((v, 1, 1, ways, 1, 1, cl))
        for r in (1, 2, 4):
            for m in sorted({max(2, mb // 2), mb, min(g, 2 * mb)}):
                for st in (1, 2, 4, 8):
                    for w in (1, 2, 4, 8, 16, 32):
                        for nb in (1, 2, 3):
                            alt = (v, r, m, min(w, per_tile * st, chains),
                                   st, nb, 1)
                            thr = CK.cols_walk_threads(I, v, r, m, alt[3])
                            if (m % r == 0 and 2 <= m <= g
                                    and thr <= CK.COLS_WALK_THREADS
                                    and (alt[3] == 1 or m * I <= 16 * thr)
                                    and CK.cols_walk_shared_bytes(
                                        K, I, m, alt[3], st, nb)
                                    <= CK.MAX_DYN_SHARED and alt not in ok):
                                ok.append(alt)

    def key(alt):                   # what the kernel makes of a plan
        v, r, m, w, st, nb, cl = alt
        if m == 1:
            return alt
        sr = st * CK.COLS_WALK_TILE
        sr = sr if K > sr else K + (K & 1)
        return v, r, m, w, sr, min(nb, -(-K // sr))

    seen = {key(tuple(plan))}
    out = []
    for alt in ok:
        if key(alt) not in seen:
            seen.add(key(alt))
            out.append(alt)
    # the direct forms, then at most WALK_SAMPLE staged ones, a seeded
    # sample
    direct = [alt for alt in out if alt[2] == 1]
    staged = [alt for alt in out if alt[2] > 1]
    if len(staged) > WALK_SAMPLE:
        pick = np.random.default_rng(5).choice(len(staged), WALK_SAMPLE,
                                               replace=False)
        staged = [staged[i] for i in sorted(pick)]
    return direct + staged


def build_walk_parts() -> ctypes.CDLL:
    src = os.path.join(_build.SRC_DIR, "tune", "cols_walk_parts.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, f"libcols_walk_parts_{os.getpid()}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.cols_walk_part.restype = i
    lib.cols_walk_part.argtypes = [i, vp, vp, i, vp, vp, i, i, i, i, i, i,
                                   i, i, i, vp]
    return lib


# (shape, staged plans) whose time the parts of tune/cols_walk_parts.cu
# split: the whole walk, no sums, copies only, sums only, the launch
PARTS = {(4, 512, 16, 512): [(2, 4, 16, 8, 4, 2)],
         (1, 1024, 16, 1024): [(2, 4, 8, 16, 4, 2)],
         # many stages: the sums' rate per SM, with little else
         (4, 8192, 16, 512): [(2, 4, 16, 8, 4, 2)]}
PART_NAMES = {0: "whole", 1: "no sums", 2: "copies only",
              3: "sums only", 4: "launch only"}


def walk_parts(dev, flush, stream, rows) -> None:
    parts = build_walk_parts()
    rng = np.random.default_rng(17)
    for shape, plans in PARTS.items():
        tables, K, I, g = shape
        M = tables * g
        hi = torch.as_tensor(rng.normal(size=(tables, K, I)).astype(
            np.float32), device=dev)
        lo = torch.as_tensor((rng.normal(size=(tables, K, I)) * 1e-8).astype(
            np.float32), device=dev)
        s = torch.as_tensor(rng.integers(-1, 2, size=(M, K)).astype(
            np.float64), device=dev)
        out = torch.empty(M, I, dtype=torch.float64, device=dev)
        for plan in plans:
            v, rm, mb, ways, st, nb = plan
            for mode, name in PART_NAMES.items():
                launch = (lambda m=mode: parts.cols_walk_part(
                    m, hi.data_ptr(), lo.data_ptr(), g, s.data_ptr(),
                    out.data_ptr(), M, K, I, v, rm, mb, ways, st, nb,
                    stream))
                err = launch()
                torch.cuda.synchronize()
                if err:
                    raise AssertionError(f"{shape} {plan} {name}: "
                                         f"cudaError {err}")
                row = {"shape": list(shape), "variant": f"parts {list(plan)}",
                       "part": name, "warm_us": call_us(launch, "cols_walk"),
                       "cold_us": call_us(launch, "cols_walk", flush)}
                rows.append(row)
                print(json.dumps(row), flush=True)


def card_rates(dev, stream, rows) -> None:
    """f64 fma rate by independent chains a thread, and the rate of 128-bit
    shared loads by addresses a warp (tune/fp64_probe.cu), per SM and clock
    at the card's current SM clock."""
    src = os.path.join(_build.SRC_DIR, "tune", "fp64_probe.cu")
    so = os.path.join(_build.BUILD_DIR, f"libfp64_probe_{os.getpid()}.so")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.fp64_probe.restype = i
    lib.fp64_probe.argtypes = [i, vp, i, i, vp]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True).stdout.strip()
    n = 4096
    for blocks_per_sm in (1, 2, 4, 8):
        blocks = blocks_per_sm * n_sm
        out = torch.empty(blocks * 256, dtype=torch.float64, device=dev)
        for which in (1, 2, 4, 8, 16, 100, 101, 102):
            launch = lambda w=which: lib.fp64_probe(w, out.data_ptr(),
                                                    blocks, n, stream)
            if launch():
                raise AssertionError(f"fp64_probe {which}: launch failed")
            torch.cuda.synchronize()
            us = call_us(launch, "")
            per = 4 if which >= 100 else which
            fmas = blocks * 256 * n * per
            row = {"rates": which, "blocks_per_sm": blocks_per_sm,
                   "us": us, "fma_per_ns_per_sm": fmas / (us * 1e3) / n_sm,
                   "sm_clock_mhz_at_start": clock}
            rows.append(row)
            print(json.dumps(row), flush=True)


def walk_section(lib, dev, flush, stream, rows, sweep=True,
                 one_member=False) -> None:
    """The walk beside the strip and the library call at WALK_SHAPES (only
    those of one member per table where ``one_member``)."""
    rng = np.random.default_rng(13)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in WALK_SHAPES:
        if one_member and shape[3] != 1:
            continue
        tables, K, I, g = shape
        M = tables * g
        dp = rng.normal(size=(tables, K, I)) * rng.integers(
            0, 2, size=(tables, K, I))
        hi_n = dp.astype(np.float32)
        lo_n = (dp - hi_n.astype(np.float64)).astype(np.float32)
        hi = torch.as_tensor(hi_n, device=dev)
        lo = torch.as_tensor(lo_n, device=dev)
        s = torch.as_tensor(rng.integers(-1, 2, size=(M, K)).astype(
            np.float64), device=dev)
        want = CK.matvec_cols_plain(hi, lo, s, members_per_table=g)
        scale = max(float(want.abs().max()), 1e-300)
        out = torch.empty_like(want)
        hp, lp, sp = hi.data_ptr(), lo.data_ptr(), s.data_ptr()

        def walk(plan, o=out):
            v, rm, mb, ways, st, nb, cl = plan
            return lambda: lib.split_matvec_cols_walk(
                hp, lp, g, sp, o.data_ptr(), M, K, I, v, rm, mb, ways, st,
                nb, cl, int(I % 4 == 0), int(K % 2 == 0), 0, stream)

        def record(label, match, launch, cold=True):
            out.zero_()
            err = launch()
            torch.cuda.synchronize()
            if err:
                raise AssertionError(f"{shape} {label}: cudaError {err}")
            rel = float((out - want).abs().max()) / scale
            if not rel <= 1e-12:
                raise AssertionError(f"{shape} {label}: relative error "
                                     f"{rel}")
            if label.startswith("walk") and not torch.equal(out, first):
                raise AssertionError(f"{shape} {label}: other bits than "
                                     f"the planned walk")
            row = {"shape": list(shape), "variant": label,
                   "warm_us": call_us(launch, match),
                   "cold_us": call_us(launch, match, flush) if cold
                   else None, "rel_err": rel}
            rows.append(row)
            print(json.dumps(row), flush=True)
            return row

        plan = CK.cols_walk_plan(tables, K, I, g, n_sm)
        out.zero_()
        walk(plan)()
        torch.cuda.synchronize()
        first = out.clone()
        record(f"walk plan={list(plan)}", "cols_walk", walk(plan))
        for m in sorted({0, g - 1, M // 2, M - 1}):
            t = m // g
            alone = CK.matvec_cols(hi[t], lo[t], s[m])
            if not torch.equal(alone, first[m]):
                raise AssertionError(f"{shape}: member {m} differs alone")
        vec, tx_log2, kc, ncb, nch = CK.cols_plan(M, K, I, True, n_sm)
        part = torch.empty(max(1, M * nch * I), dtype=torch.float64,
                           device=dev)
        tick = torch.zeros(max(1024, M * ncb), dtype=torch.int32,
                           device=dev)
        record(f"strip plan={[vec, tx_log2, kc, ncb, nch]}", "cols_kernel",
               lambda: lib.split_matvec_cols(
                   hp, lp, g, sp, part.data_ptr(), tick.data_ptr(),
                   out.data_ptr(), M, K, I, vec, tx_log2, kc, 0, stream))
        dpd = hi.double() + lo.double()
        sg = s.reshape(tables, g, K)
        lib_out = out.view(tables, g, I)
        record("torch.bmm on the f64 tables", None,
               lambda: (torch.bmm(sg, dpd, out=lib_out), 0)[1])
        # every variant warm, then the four fastest cold too; each must
        # give the planned walk's bits
        alts = walk_variants(plan, I, K, g)
        if not sweep:                       # the direct forms only
            alts = [alt for alt in alts if alt[2] == 1] if g == 1 else []
        # where members share a table, the direct form for every member
        direct = CK._cols_direct_plan(tables * g, K, I, n_sm)
        if g > 1 and direct != tuple(plan) and direct not in alts:
            alts.append(direct)
        warm = [(record(f"walk {list(alt)}", "cols_walk", walk(alt),
                        cold=False)["warm_us"], alt) for alt in alts]
        for _, alt in sorted(warm)[:4]:
            record(f"walk {list(alt)}", "cols_walk", walk(alt))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    walk_rows = []
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    if "--rates" in sys.argv:
        card_rates(dev, stream, walk_rows)
    if "--parts" in sys.argv:
        walk_parts(dev, flush, stream, walk_rows)
    walk_section(lib, dev, flush, stream, walk_rows,
                 sweep="--no-sweep" not in sys.argv,
                 one_member="--one-member" in sys.argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if "--walk-only" in sys.argv:
        if len(sys.argv) > 1 and not sys.argv[1].startswith("--"):
            with open(sys.argv[1], "w") as f:
                json.dump({"card": card, "walk": walk_rows}, f, indent=1)
        print(card)
        return 0
    var = build_variants()
    rng = np.random.default_rng(7)
    dp = rng.normal(size=(K, I)) * rng.integers(0, 2, size=(K, I))
    hi_n = dp.astype(np.float32)
    lo_n = (dp - hi_n.astype(np.float64)).astype(np.float32)
    hi = torch.as_tensor(hi_n, device=dev)
    lo = torch.as_tensor(lo_n, device=dev)
    sv = rng.choice([-1.0, 1.0], size=K)
    sv[4000:] = 0.0
    s = torch.as_tensor(sv, device=dev)
    want = CK.matvec_cols_plain(hi, lo, s)
    scale = float(want.abs().max())
    out = torch.empty(I, dtype=torch.float64, device=dev)
    partial = torch.empty(K * I, dtype=torch.float64, device=dev)
    tickets = torch.zeros(1024, dtype=torch.int32, device=dev)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rows = []

    def run(label, match, launch, checked=True):
        out.zero_()
        err = launch()
        torch.cuda.synchronize()
        if err != 0:
            raise AssertionError(f"{label}: cudaError {err}")
        rel = float((out - want).abs().max()) / scale if checked else None
        if checked and not rel <= 1e-12:
            raise AssertionError(f"{label}: relative error {rel}")
        if int(tickets.abs().sum()) != 0:
            raise AssertionError(f"{label}: tickets not reset")
        row = {"variant": label, "warm_us": device_us(launch, match),
               "cold_us": device_us(launch, match, flush), "rel_err": rel}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for tx_log2 in (3, 4, 5):
        one_pass = (256 >> tx_log2) * 4
        for passes in (1, 2, 4):
            kc = one_pass * passes
            run(f"kernel tx={1 << tx_log2} kc={kc} "
                f"blocks={(I // (4 << tx_log2)) * (K // kc)}", "cols_kernel",
                lambda t=tx_log2, k=kc: lib.split_matvec_cols(
                    hi.data_ptr(), lo.data_ptr(), 1, s.data_ptr(),
                    partial.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                    1, K, I, 4, t, k, 0, stream))
    for which, name in ((1, "cols_cpasync"), (2, "cols_noskip")):
        for tx_log2, kc in ((4, 64), (5, 32), (4, 128)):
            run(f"{name} tx={1 << tx_log2} kc={kc}", name,
                lambda w=which, t=tx_log2, k=kc: var.cols_variant(
                    w, hi.data_ptr(), lo.data_ptr(), 0, s.data_ptr(),
                    partial.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                    1, K, I, t, k, stream))
    # where the time goes, at the launch shape the wrapper picks (tx=16,
    # kc=128): the same grid empty, the row stream without ticket and
    # combine, and the whole kernel with σ = 0 (no row is read)
    for which, name in ((4, "cols_empty"), (3, "cols_notail")):
        run(f"{name} tx=16 kc=128", name,
            lambda w=which: var.cols_variant(
                w, hi.data_ptr(), lo.data_ptr(), 0, s.data_ptr(),
                partial.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                1, K, I, 4, 128, stream), checked=False)
    s0 = torch.zeros_like(s)
    for name, which in (("cols_notail", 3), ("cols_kernel", 0)):
        run(f"{name} tx=16 kc=128 sigma=0", name,
            (lambda: var.cols_variant(
                3, hi.data_ptr(), lo.data_ptr(), 0, s0.data_ptr(),
                partial.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                1, K, I, 4, 128, stream)) if which else
            (lambda: lib.split_matvec_cols(
                hi.data_ptr(), lo.data_ptr(), 1, s0.data_ptr(),
                partial.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                1, K, I, 4, 4, 128, 0, stream)), checked=False)
    run("wrapper (cols_plan)", "cols_kernel",
        lambda: (out.copy_(CK.matvec_cols(hi, lo, s)), 0)[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump({"card": card, "walk": walk_rows, "K": K, "I": I,
                       "timings": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
