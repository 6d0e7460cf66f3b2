"""The phasing ascent's split-Dp contractions: CUDA kernels + plain versions.

Counterpart of ``longcallr_tpu/phasing/pallas_kernels.py``. ``Dp`` is one
region's emission matrix stored as an exact two-term f32 split ``hi + lo``
(see kernels_fast.py). Two contractions carry the ascent:

* ``dual_matvec_rows(hi, lo, x)``: ``Dp·x`` for x [I, 2] (both operand
  columns u, v in one pass) — the σ half-step and the objective;
* ``matvec_cols(hi, lo, s)``: ``Dpᵀ·s`` — the (δ, η) half-step and the
  block-flip pass.

Both take an optional leading batch axis on the operand (and on hi/lo, or
hi/lo shared by the whole batch — the enumeration path's configs share one
Dp). On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/split_matvec.cu`` (built at first use, see ``_build.py``) or raises;
on a CPU tensor it takes the plain version, ``(hi.double() + lo.double())``
contracted in f64. The kernel accumulates in f64, so it agrees with the
plain version up to summation order.

A call costs little beside its kernel: operands that are already what the
kernel takes (contiguous, [K,I] tables or a batch of them) go straight to
the launch — dtype, shape, device and contiguity are still checked, but
nothing is copied, no device context is entered (the C entry point selects
the device) and the only allocation is the result. Anything else (a
broadcast batch, a strided view) is first made contiguous.

``matvec_cols`` needs scratch on the card when K is cut into chunks: the
chunks' partial sums and one ticket per column block. It is kept per
(device, stream) in ``_WORKSPACES`` and reused by every call, which is safe
because launches on one stream run in order: two host threads that share a
stream share a workspace and their kernels serialise; threads on different
streams get different workspaces.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls are not
counted), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Tuple

import torch

LAUNCHES = {"dual_matvec_rows": 0, "matvec_cols": 0}
_count_lock = threading.Lock()

# the cols kernel's block: 256 threads, 4 rows in flight per thread, at most
# 1024 rows of σ staged per block (csrc/split_matvec.cu)
COLS_THREADS = 256
COLS_UNROLL = 4
COLS_MAX_CHUNK = 1024
# widest block in column threads (log2), by columns per thread: 16 threads of
# 4 columns, or 32 threads of 1
COLS_MAX_TX_LOG2 = {4: 4, 1: 5}
# blocks per SM the cols grid aims for
COLS_BLOCKS_PER_SM = 2
# a block's strip of hi + lo (K rows by its columns) up to this size is not
# cut into K chunks: ticket and combine cost about 2.3 µs on an H100, as
# long as one SM takes to stream some 128 KiB
COLS_SPLIT_MIN_BYTES = 128 << 10
# CUDA's limit on the grid's second and third dimension
_GRID_YZ_MAX = 65535


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def dual_matvec_rows_plain(hi, lo, x) -> torch.Tensor:
    """Plain PyTorch version: (hi + lo) in f64 times x → [..., K, 2]."""
    return torch.matmul(hi.double() + lo.double(), x.double())


def matvec_cols_plain(hi, lo, s) -> torch.Tensor:
    """Plain PyTorch version: sᵀ·(hi + lo) in f64 → [..., I]."""
    dp = hi.double() + lo.double()
    return torch.matmul(s.double().unsqueeze(-2), dp).squeeze(-2)


def _usual(hi, lo, op, vec_dims: int):
    """The usual case, checked with as little host work as it takes: [K,I]
    float32 tables and a float64 operand ([I,2] / [K], or a batch of them),
    all contiguous and on one device, are what the kernels take as they
    are. Returns (B, batched-output?) then, and None for anything else —
    which ``_operands`` then brings into shape or refuses."""
    hs, ops = hi.shape, op.shape
    lead = len(ops) - vec_dims
    if len(hs) != 2 or lo.shape != hs or lead not in (0, 1):
        return None
    if vec_dims == 1:
        if ops[-1] != hs[0]:
            return None
    elif ops[-2] != hs[1] or ops[-1] != 2:
        return None
    if (hi.dtype is not torch.float32 or lo.dtype is not torch.float32
            or op.dtype is not torch.float64):
        return None
    dev = hi.device
    if lo.device != dev or op.device != dev:
        return None
    if not (hi.is_contiguous() and lo.is_contiguous()
            and op.is_contiguous()):
        return None
    return (ops[0], True) if lead else (1, False)


def _operands(hi, lo, op, vec_dims: int):
    """Check hi/lo and the operand (``vec_dims`` trailing dims: [I,2] or
    [K]) and bring them to what the kernels take. Returns (B, hi/lo batch
    stride in elements, operand as contiguous [B, ...] — or unbatched when
    B is 1, the same memory —, batched-output?). A stride of 0 shares one Dp
    across the batch."""
    usual = _usual(hi, lo, op, vec_dims)
    if usual is not None:
        return usual[0], 0, op, usual[1]
    if hi.dtype != torch.float32 or lo.dtype != torch.float32:
        raise TypeError(f"hi/lo must be float32, got {hi.dtype}/{lo.dtype}")
    if op.dtype != torch.float64:
        raise TypeError(f"the operand must be float64, got {op.dtype}")
    hd, od = hi.dim(), op.dim()
    if hi.shape != lo.shape or hd not in (2, 3):
        raise ValueError(f"hi/lo must share a [K,I] or [B,K,I] shape, got "
                         f"{tuple(hi.shape)} / {tuple(lo.shape)}")
    if hi.device != lo.device or hi.device != op.device:
        raise ValueError("all operands must be on one device")
    K, I = hi.shape[-2], hi.shape[-1]
    want = (I, 2) if vec_dims == 2 else (K,)
    if od not in (vec_dims, vec_dims + 1) or op.shape[-vec_dims:] != want:
        raise ValueError(f"the operand must be [..., {', '.join(map(str, want))}]"
                         f", got {tuple(op.shape)}")
    op_b = op.shape[0] if od == vec_dims + 1 else None
    hl_b = hi.shape[0] if hd == 3 else None
    if op_b is not None and hl_b is not None and hl_b not in (1, op_b):
        raise ValueError(f"batch mismatch: Dp {hl_b} vs operand {op_b}")
    B = op_b if op_b is not None else (hl_b or 1)
    stride = K * I if (hl_b is not None and hl_b == B and B > 1) else 0
    if op_b is None and B > 1:          # one operand for a batch of tables
        op = op.expand(B, *want)
    if not op.is_contiguous():
        op = op.contiguous()
    if not (hi.is_contiguous() and lo.is_contiguous()):
        raise ValueError("hi and lo must be contiguous")
    return B, stride, op, (op_b is not None or hl_b is not None)


def _ceil_log2(n: int) -> int:
    return max(0, (n - 1).bit_length())


def rows_lanes(I: int) -> int:
    """Lanes that stride one row in the rows kernel: 32 for wide tables,
    fewer (down to 4) when I is small, so that a warp covers several rows
    and no lane idles."""
    return min(32, max(4, 1 << _ceil_log2(I)))


@functools.lru_cache(maxsize=4096)
def cols_plan(B: int, K: int, I: int, aligned: bool, n_sm: int
              ) -> Tuple[int, int, int, int, int]:
    """Launch shape of the cols kernel for one call: (columns per thread,
    log2 of the column threads per block, rows per block, column blocks,
    K chunks). ``aligned`` says that hi and lo may be read 16 bytes at a
    time. The K chunk is whole passes of the block (row lanes × unroll):
    all of K where one block's strip of the table is small enough
    (COLS_SPLIT_MIN_BYTES) that cutting it would cost more in ticket and
    combine than it saves, else the number of passes that brings the grid
    nearest to COLS_BLOCKS_PER_SM blocks for each of the card's ``n_sm``
    SMs, and at most COLS_MAX_CHUNK rows."""
    vec = 4 if (aligned and I % 4 == 0) else 1
    tx_log2 = min(COLS_MAX_TX_LOG2[vec], _ceil_log2(-(-I // vec)))
    width = (1 << tx_log2) * vec
    ncb = -(-I // width)
    one_pass = (COLS_THREADS >> tx_log2) * COLS_UNROLL
    if K <= COLS_MAX_CHUNK and K * width * 8 <= COLS_SPLIT_MIN_BYTES:
        return vec, tx_log2, one_pass * -(-K // one_pass), ncb, 1
    chunks_wanted = max(1, COLS_BLOCKS_PER_SM * n_sm // (B * ncb))
    passes = max(1, min((2 * K + one_pass * chunks_wanted)
                        // (2 * one_pass * chunks_wanted),
                        COLS_MAX_CHUNK // one_pass))
    kc = one_pass * passes
    return vec, tx_log2, kc, ncb, -(-K // kc)


_SM_COUNT: Dict[int, int] = {}
# (device index, stream handle) → [partial f64, tickets int32]; see the
# module docstring for why sharing per stream is safe
_WORKSPACES: Dict[Tuple[int, int], list] = {}
_ws_lock = threading.Lock()


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _stream(device: torch.device) -> int:
    """The raw handle of the stream PyTorch would launch on."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _workspace(device: torch.device, stream: int, n_partial: int,
               n_tickets: int):
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < n_partial or ws[1].numel() < n_tickets:
        with _ws_lock:
            ws = _WORKSPACES.get(key)
            have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
            if have[0] < n_partial or have[1] < n_tickets:
                # a replaced tensor is freed only after the launches that
                # use it were enqueued, and the allocator reuses it in
                # stream order; the kernel leaves every ticket at zero
                ws = [torch.empty(max(n_partial, 2 * have[0]),
                                  dtype=torch.float64, device=device),
                      torch.zeros(max(n_tickets, 2 * have[1], 1024),
                                  dtype=torch.int32, device=device)]
                _WORKSPACES[key] = ws
    return ws


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    dev = t.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dual_matvec_rows(hi: torch.Tensor, lo: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """``(hi + lo) @ x`` → [..., K, 2] float64. hi/lo [K,I] or [B,K,I]
    float32; x [I,2] or [B,I,2] float64."""
    B, stride, x, batched = _operands(hi, lo, x, 2)
    if hi.device.type == "cpu":
        return dual_matvec_rows_plain(hi, lo, x)
    dev = _cuda_device(hi)
    K, I = hi.shape[-2], hi.shape[-1]
    if B > _GRID_YZ_MAX:
        raise ValueError(f"batch {B} exceeds the kernel's grid")
    out = torch.empty((B, K, 2) if batched else (K, 2), dtype=torch.float64,
                      device=dev)
    if K and I and B:
        from .._build import load
        err = load().split_dual_matvec_rows(
            hi.data_ptr(), lo.data_ptr(), stride, x.data_ptr(),
            out.data_ptr(), B, K, I, rows_lanes(I), dev.index, _stream(dev))
        if err != 0:
            raise RuntimeError(f"split_dual_matvec_rows launch failed: "
                               f"cudaError {err}")
        _count("dual_matvec_rows")
    else:
        out.zero_()
    return out


def matvec_cols(hi: torch.Tensor, lo: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``sᵀ (hi + lo)`` → [..., I] float64. hi/lo [K,I] or [B,K,I] float32;
    s [K] or [B,K] float64."""
    B, stride, s, batched = _operands(hi, lo, s, 1)
    if hi.device.type == "cpu":
        return matvec_cols_plain(hi, lo, s)
    dev = _cuda_device(hi)
    K, I = hi.shape[-2], hi.shape[-1]
    out = torch.empty((B, I) if batched else (I,), dtype=torch.float64,
                      device=dev)
    if K and I and B:
        from .._build import load
        hp, lp = hi.data_ptr(), lo.data_ptr()
        vec, tx_log2, kc, ncb, nch = cols_plan(
            B, K, I, (hp | lp) % 16 == 0, _sm_count(dev))
        if B > _GRID_YZ_MAX or nch > _GRID_YZ_MAX:
            raise ValueError(f"batch {B} / {nch} K chunks exceed the "
                             f"kernel's grid")
        stream = _stream(dev)
        part = tick = 0
        if nch > 1:
            ws = _workspace(dev, stream, B * nch * I, B * ncb)
            part, tick = ws[0].data_ptr(), ws[1].data_ptr()
        err = load().split_matvec_cols(
            hp, lp, stride, s.data_ptr(), part, tick, out.data_ptr(),
            B, K, I, vec, tx_log2, kc, dev.index, stream)
        if err != 0:
            raise RuntimeError(f"split_matvec_cols launch failed: "
                               f"cudaError {err}")
        _count("matvec_cols")
    else:
        out.zero_()
    return out
