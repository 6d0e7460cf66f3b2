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

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls are not
counted), so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

LAUNCHES = {"dual_matvec_rows": 0, "matvec_cols": 0}
_count_lock = threading.Lock()

# rows of Dp per block of the cols kernel's first pass
COLS_K_CHUNK = 128


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


def _check_split(hi, lo) -> Tuple[int, int]:
    if hi.dtype != torch.float32 or lo.dtype != torch.float32:
        raise TypeError(f"hi/lo must be float32, got {hi.dtype}/{lo.dtype}")
    if hi.shape != lo.shape or hi.dim() not in (2, 3):
        raise ValueError(f"hi/lo must share a [K,I] or [B,K,I] shape, got "
                         f"{tuple(hi.shape)} / {tuple(lo.shape)}")
    if hi.device != lo.device:
        raise ValueError("hi and lo must be on one device")
    return hi.shape[-2], hi.shape[-1]


def _batch(hi, op, vec_dims: int):
    """(B, hi/lo batch stride in elements, operand as [B, ...],
    batched-output?) for an operand with ``vec_dims`` trailing dims. A
    stride of 0 shares one Dp across the batch."""
    K, I = hi.shape[-2], hi.shape[-1]
    op_b = op.shape[0] if op.dim() == vec_dims + 1 else None
    hl_b = hi.shape[0] if hi.dim() == 3 else None
    if op_b is not None and hl_b is not None and hl_b not in (1, op_b):
        raise ValueError(f"batch mismatch: Dp {hl_b} vs operand {op_b}")
    B = op_b if op_b is not None else (hl_b or 1)
    stride = K * I if (hl_b is not None and hl_b == B and B > 1) else 0
    op = op.expand(B, *op.shape[-vec_dims:]).contiguous()
    return B, stride, op, (op_b is not None or hl_b is not None)


def _cuda_ready(*ts) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def dual_matvec_rows(hi: torch.Tensor, lo: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """``(hi + lo) @ x`` → [..., K, 2] float64. hi/lo [K,I] or [B,K,I]
    float32; x [I,2] or [B,I,2] float64."""
    K, I = _check_split(hi, lo)
    if x.dtype != torch.float64 or x.shape[-2:] != (I, 2) or x.dim() > 3:
        raise ValueError(f"x must be float64 [..., {I}, 2], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if hi.device.type == "cpu" and x.device.type == "cpu":
        return dual_matvec_rows_plain(hi, lo, x)
    if hi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {hi.device}")
    B, stride, x, batched = _batch(hi, x, 2)
    _cuda_ready(hi, lo, x)
    out = torch.empty((B, K, 2), dtype=torch.float64, device=hi.device)
    if K and I and B:
        from .._build import load
        lib = load()
        with torch.cuda.device(hi.device):
            err = lib.split_dual_matvec_rows(
                hi.data_ptr(), lo.data_ptr(), stride, x.data_ptr(),
                out.data_ptr(), B, K, I,
                torch.cuda.current_stream(hi.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"split_dual_matvec_rows launch failed: "
                               f"cudaError {err}")
        _count("dual_matvec_rows")
    else:
        out.zero_()
    return out if batched else out[0]


def matvec_cols(hi: torch.Tensor, lo: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``sᵀ (hi + lo)`` → [..., I] float64. hi/lo [K,I] or [B,K,I] float32;
    s [K] or [B,K] float64."""
    K, I = _check_split(hi, lo)
    if s.dtype != torch.float64 or s.shape[-1] != K or s.dim() > 2:
        raise ValueError(f"s must be float64 [..., {K}], got "
                         f"{s.dtype} {tuple(s.shape)}")
    if hi.device.type == "cpu" and s.device.type == "cpu":
        return matvec_cols_plain(hi, lo, s)
    if hi.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {hi.device}")
    B, stride, s, batched = _batch(hi, s, 1)
    _cuda_ready(hi, lo, s)
    out = torch.empty((B, I), dtype=torch.float64, device=hi.device)
    if K and I and B:
        from .._build import load
        lib = load()
        kc = COLS_K_CHUNK
        partial = torch.empty((B, (K + kc - 1) // kc, I), dtype=torch.float64,
                              device=hi.device)
        with torch.cuda.device(hi.device):
            err = lib.split_matvec_cols(
                hi.data_ptr(), lo.data_ptr(), stride, s.data_ptr(),
                partial.data_ptr(), out.data_ptr(), B, K, I, kc,
                torch.cuda.current_stream(hi.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"split_matvec_cols launch failed: "
                               f"cudaError {err}")
        _count("matvec_cols")
    else:
        out.zero_()
    return out if batched else out[0]
