"""Time the cols kernel's launch shapes and row-stream variants on a CUDA card.

    python3 experiments/torch_cols_variants.py [out.json]

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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = _build.load()
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
    stream = torch.cuda.current_stream(dev).cuda_stream
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
            json.dump({"card": card, "K": K, "I": I, "timings": rows}, f,
                      indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
