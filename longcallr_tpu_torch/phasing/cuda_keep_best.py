"""The enumeration leg's keep-best: a CUDA kernel + its plain version.

The JAX package picks an enumeration region's winning configuration on the
host: it walks the configurations' objectives in enumeration order and takes
the first that beats the running best by more than ``TIE_TOL``
(``longcallr_tpu/phasing/optimize.py``, its enumeration leg, and
``longcallr_tpu/phasing/batch_driver.py::_phase_enum_bucket``). ``keep_best``
runs that walk on the card, one block of ``csrc/keep_best.cu`` (built into
the same library as ``csrc/split_matvec.cu``, see ``_build.py``; its warp
takes the first of 32 objectives that beats the running best, then asks
again after it: the sequential rule's picks), so that
the enumeration programs of a wave (``phasing/enum_wave.py``) end with the
winner and the host reads no objective between them. The chunks of one
region's configurations chain through ``prev``: each chunk's walk starts from
the best of the chunks before it.

The walk compares float64 values and adds ``tol`` to the running best, as
the host loop does, so the kernel and the plain version agree bit for bit.

``KEEP_BEST_LAUNCHES`` counts kernel launches (plain-version calls are not
counted); ``cuda_kernels.reset_launches`` clears it. Under a capture a
launch is recorded (``cuda_kernels.recording``) and counted at every run of
the device program, as the other wrappers' are.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_kernels as CK

KEEP_BEST_LAUNCHES = {"keep_best": 0}


def reset_keep_best_launches() -> None:
    with CK._count_lock:
        KEEP_BEST_LAUNCHES["keep_best"] = 0


def add_keep_best_launches(n: int = 1) -> None:
    """Count ``n`` launches (the caller holds ``cuda_kernels._count_lock``)."""
    KEEP_BEST_LAUNCHES["keep_best"] += n


def _check(probs: torch.Tensor, prev: torch.Tensor) -> None:
    if probs.dtype is not torch.float64 or probs.dim() != 1:
        raise ValueError(f"probs must be float64 [C], got {probs.dtype} "
                         f"{tuple(probs.shape)}")
    if prev.dtype is not torch.float64 or prev.dim() != 0:
        raise ValueError(f"prev must be a float64 scalar, got {prev.dtype} "
                         f"{tuple(prev.shape)}")
    if prev.device != probs.device:
        raise ValueError(f"prev on {prev.device}, probs on {probs.device}")


def keep_best_plain(probs: torch.Tensor, prev: torch.Tensor, tol: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The walk on the host: (best, index) as a float64 and an int64
    scalar on ``probs``' device; index -1 where no value beat ``prev`` by
    more than ``tol`` (best is then ``prev``)."""
    _check(probs, prev)
    best, sel = float(prev), -1
    for j, p in enumerate(probs.tolist()):
        if p > best + tol:
            best, sel = p, j
    dev = probs.device
    return (torch.tensor(best, dtype=torch.float64, device=dev),
            torch.tensor(sel, dtype=torch.int64, device=dev))


def _out(out, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    if out is None:
        return (torch.empty((), dtype=torch.float64, device=dev),
                torch.empty((), dtype=torch.int64, device=dev))
    for o, dt in zip(out, (torch.float64, torch.int64)):
        if o.dtype is not dt or o.dim() != 0 or o.device != dev:
            raise ValueError(f"out must be ({dt} scalar) on {dev}, got "
                             f"{o.dtype} {tuple(o.shape)} on {o.device}")
    return tuple(out)


def keep_best(probs: torch.Tensor, prev: torch.Tensor, tol: float,
              out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first of ``probs`` (float64 [C], enumeration order) that beats
    the running best ``prev`` (float64 scalar) by more than ``tol``, then
    the first that beats that one, and so on: (best, index) scalars,
    written into ``out`` where given (a device program's buffers). On a CPU
    tensor the plain version; on a CUDA tensor one launch of the kernel on
    the current stream, or an error."""
    _check(probs, prev)
    if probs.device.type == "cpu":
        best, sel = _out(out, probs.device)
        for o, v in zip((best, sel), keep_best_plain(probs, prev, tol)):
            o.copy_(v)
        return best, sel
    if not probs.is_contiguous():
        raise ValueError("probs must be contiguous")
    dev = CK._cuda_device(probs)
    best, sel = _out(out, dev)
    from .._build import load
    err = load().keep_best(probs.data_ptr(), probs.shape[0], prev.data_ptr(),
                           float(tol), best.data_ptr(), sel.data_ptr(),
                           dev.index, CK._stream(dev))
    if err != 0:
        raise RuntimeError(f"keep_best launch failed: cudaError {err}")
    rec = getattr(CK._recorded, "launches", None)
    if rec is not None:
        rec.append(("keep_best", (probs.shape[0],), dev.index))
    else:
        with CK._count_lock:
            add_keep_best_launches()
    return best, sel
