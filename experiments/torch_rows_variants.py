"""Time the rows kernel beside its earlier design and stream variants.

    python3 experiments/torch_rows_variants.py [out.json]

Device time per launch by kernel name in torch.profiler, the tables warm in L2
and cold (256 MB written and read back before each launch):

  * at enumeration shapes (tables, K, I; members per table) — among them
    (4, 512, 16; 64), the shape the redesign was chosen by — the kernel of
    longcallr_tpu_torch/csrc/split_matvec.cu as the wrapper plans it, the
    earlier design (csrc/tune/rows_variants.cu ``rows_members_grid``: members
    on the grid, every member's blocks read the table again), and one
    torch.bmm on the f64 tables; then the kernel with other numbers of members
    walked by a block (``mb``), around the wrapper's choice;
  * at one member per table and short rows (I = 16, 32), where a thread now
    keeps a whole row: kernel against the earlier design;
  * at the deep shapes (1 | 2 | 4, 4096, 512; 1): the kernel's stream (a warp
    per row, 4-byte loads) against the earlier design and against
    ``rows_stream`` with 16-byte loads and with two rows of a warp in flight.

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

# (tables, K, I, members per table)
ENUM_SHAPES = [(4, 512, 16, 64), (4, 512, 8, 64), (1, 512, 8, 64),
               (4, 512, 16, 512), (1, 512, 16, 1024), (12, 64, 8, 16),
               (1, 64, 8, 16)]
SHORT_ROW_SHAPES = [(8, 4096, 16, 1), (8, 4096, 32, 1), (64, 512, 16, 1)]
DEEP_SHAPES = [(1, 4096, 512, 1), (2, 4096, 512, 1), (4, 4096, 512, 1)]
MB_SWEEP = {(4, 512, 16, 64): (1, 2, 4, 8, 16, 64),
            (4, 512, 16, 512): (2, 4, 8, 16, 32, 64),
            (1, 512, 16, 1024): (1, 2, 4, 8, 16, 32),
            (12, 64, 8, 16): (4, 8, 16), (1, 64, 8, 16): (4, 8, 16),
            (1, 512, 8, 64): (1, 2, 4, 8)}
# the kernels of the flush (zero_ and sum of a float32 buffer)
_FLUSH_KERNELS = ("FillFunctor", "Memset", "at::native::reduce_kernel")
STREAMS = {1: "stream vec=1 rows=1", 2: "stream vec=4 rows=1",
           3: "stream vec=1 rows=2", 4: "stream vec=4 rows=2"}


def build_variants() -> ctypes.CDLL:
    src = os.path.join(_build.SRC_DIR, "tune", "rows_variants.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    so = os.path.join(_build.BUILD_DIR, f"librows_variants_{os.getpid()}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.rows_variant.restype = i
    lib.rows_variant.argtypes = [i, vp, vp, i, vp, vp, i, i, i, i, vp]
    return lib


def device_us(fn, match, flush=None, n: int = 30) -> float:
    """Mean device time (µs) per call of the kernels whose name contains
    one of ``match``; with ``match`` None, of every kernel but those of the
    flush."""
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
        if match is None:
            hits = [e for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not any(w in e.key for w in _FLUSH_KERNELS)]
        else:
            hits = [e for e in prof.key_averages()
                    if any(m in e.key for m in match)]
        if hits:
            break
    else:
        raise AssertionError(f"no kernel named {match} in "
                             f"{[e.key[:60] for e in prof.key_averages()]}")
    return sum(e.self_device_time_total for e in hits) / n


def old_lanes(I: int) -> int:
    """Lanes per row of the earlier design."""
    return min(32, max(4, 1 << max(0, (I - 1).bit_length())))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = _build.load()
    var = build_variants()
    rng = np.random.default_rng(11)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []

    def inputs(tables, K, I, g):
        dp = rng.normal(size=(tables, K, I)) * rng.integers(
            0, 2, size=(tables, K, I))
        hi_n = dp.astype(np.float32)
        lo_n = (dp - hi_n.astype(np.float64)).astype(np.float32)
        x = rng.integers(-1, 2, size=(tables * g, I, 2)).astype(np.float64)
        return (torch.as_tensor(hi_n, device=dev),
                torch.as_tensor(lo_n, device=dev),
                torch.as_tensor(x, device=dev))

    def run(shape, label, match, launch, out, want):
        out.zero_()
        err = launch()
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"{shape} {label}: cudaError {err}")
        rel = float((out - want).abs().max()) / float(want.abs().max())
        if not rel <= 1e-12:
            raise AssertionError(f"{shape} {label}: relative error {rel}")
        row = {"shape": list(shape), "variant": label,
               "warm_us": device_us(launch, match),
               "cold_us": device_us(launch, match, flush), "rel_err": rel}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def kernel(hi, lo, x, out, shape, plan):
        tables, K, I, g = shape
        rt_log2, ways_log2, mb = plan
        vec = int(I % 4 == 0)
        return lambda: lib.split_dual_matvec_rows(
            hi.data_ptr(), lo.data_ptr(), g, x.data_ptr(), out.data_ptr(),
            tables * g, K, I, rt_log2, ways_log2, mb, vec, 0, stream)

    def variant(which, hi, lo, x, out, shape, lanes=32):
        tables, K, I, g = shape
        return lambda: var.rows_variant(
            which, hi.data_ptr(), lo.data_ptr(), g, x.data_ptr(),
            out.data_ptr(), tables * g, K, I, lanes, stream)

    for shape in ENUM_SHAPES + SHORT_ROW_SHAPES:
        tables, K, I, g = shape
        hi, lo, x = inputs(*shape)
        want = CK.dual_matvec_rows_plain(hi, lo, x, members_per_table=g)
        out = torch.empty_like(want)
        plan = CK.rows_plan(tables, K, I, g, n_sm)
        run(shape, f"kernel plan={list(plan)}", ("rows_walk", "rows_lanes"),
            kernel(hi, lo, x, out, shape, plan), out, want)
        run(shape, f"members on the grid, lanes={old_lanes(I)}",
            ("rows_members_grid",),
            variant(0, hi, lo, x, out, shape, old_lanes(I)), out, want)
        # the library call: one bmm, the members of a table side by side
        dpd = hi.double() + lo.double()
        xr = x.reshape(tables, g, I, 2).permute(0, 2, 1, 3).reshape(
            tables, I, g * 2).contiguous()
        lib_out = torch.empty(tables, K, g * 2, dtype=torch.float64,
                              device=dev)
        run(shape, "torch.bmm on the f64 tables", None,
            lambda: (torch.bmm(dpd, xr, out=lib_out), 0)[1],
            lib_out.reshape(tables, K, g, 2).permute(0, 2, 1, 3),
            want.reshape(tables, g, K, 2))
        for mb in MB_SWEEP.get(shape, ()):
            run(shape, f"kernel mb={mb}", ("rows_walk",),
                kernel(hi, lo, x, out, shape, (plan[0], plan[1], mb)), out,
                want)

    for shape in DEEP_SHAPES:
        tables, K, I, g = shape
        hi, lo, x = inputs(*shape)
        want = CK.dual_matvec_rows_plain(hi, lo, x, members_per_table=g)
        out = torch.empty_like(want)
        plan = CK.rows_plan(tables, K, I, g, n_sm)
        # kernel, variants, variants, kernel: both ends of the turn
        run(shape, "kernel", ("rows_lanes",),
            kernel(hi, lo, x, out, shape, plan), out, want)
        old = (0, "members on the grid, lanes=32")
        for which, label in [old] + list(STREAMS.items()) + list(
                reversed(STREAMS.items())) + [old]:
            run(shape, label, ("rows_stream", "rows_members_grid"),
                variant(which, hi, lo, x, out, shape), out, want)
        run(shape, "kernel", ("rows_lanes",),
            kernel(hi, lo, x, out, shape, plan), out, want)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump({"card": card, "timings": rows}, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
