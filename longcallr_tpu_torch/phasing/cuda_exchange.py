"""The reads-sharded ascent's exchange: a CUDA kernel + its plain version.

The JAX package's sharded ascent (``longcallr_tpu/parallel/mesh.py:504-617``,
``sharded_cross_optimize``) is one SPMD program over the "reads" axis whose
shards meet only in ``jax.lax.psum``: the column sums (``:536-539``), the
flip count (``:554``), ``dpᵀσ`` (``:558``) and the objective (``:604``).
Here each shard runs a device program of its own (``phasing/graphs.py``,
``Group``), and at each of those points every shard launches ``exchange``:
the hand-written kernel of ``csrc/shard_exchange.cu``, which publishes the
shard's partial to every shard, waits until every shard has published (a
barrier on the device, bounded by ``WAIT_NS`` of the device clock, past
which it traps: a CUDA error, never a hang) and sums the partials in shard
order. The plain version, ``sum_in_order``, adds the same partials in the
same order on one device (the sum that stands for the psum wherever the
port's "reads" axis meets, ``parallel/mesh.py``), so every shard's total
is bit-equal to it and to every other shard's.

A ``ShardExchange`` holds a group's buffers: per shard, on its device, a
buffer of two halves of n slots (``cap`` words of 8 bytes each), n arrival
flags, the shard's [generation, barrier turns] and a table of the buffers'
and flags' addresses. A group over distinct cards enables peer access
between every pair and raises where a pair cannot reach each other; a group
over devices of two kinds raises.

``EXCHANGE_LAUNCHES`` counts the kernel's launches (not in
``cuda_kernels.LAUNCHES``: the sharded ascent launches no split-matvec
kernel, and its checks say so); under capture a launch is recorded and
counted at every run of its piece, as the matvec wrappers' are.
``cuda_kernels.reset_launches`` clears it.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import cuda_kernels as CK

EXCHANGE_LAUNCHES = {"shard_exchange": 0}

# longest a shard waits for the others at one exchange before the kernel
# traps (device clock, ns): far above a trip of the giant locus, and far
# below anything a caller would wait out
WAIT_NS = 5_000_000_000

_NAME = "shard_exchange"


def reset_exchange_launches() -> None:
    with CK._count_lock:
        EXCHANGE_LAUNCHES[_NAME] = 0


def add_exchange_launches(n: int = 1) -> None:
    """Count ``n`` launches (the caller holds ``cuda_kernels._count_lock``)."""
    EXCHANGE_LAUNCHES[_NAME] += n


def _count(device_index: int) -> None:
    rec = getattr(CK._recorded, "launches", None)
    if rec is not None:
        rec.append((_NAME, None, device_index))
        return
    with CK._count_lock:
        add_exchange_launches()


def sum_in_order(parts: Sequence[torch.Tensor],
                 home: torch.device) -> torch.Tensor:
    """The plain exchange: Σ of the per-shard partials in shard order on
    ``home``, the same for every run."""
    total = parts[0].to(home)
    for p in parts[1:]:
        total = total + p.to(home)
    return total


def _raise(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"shard exchange: {what} failed: cudaError {err}")


class ShardExchange:
    """The exchange buffers of a group of shards on ``devices`` (a device
    may repeat), for partials of up to ``cap`` words (f64 and int64)."""

    def __init__(self, devices: Sequence[torch.device], cap: int):
        devs = [torch.device(d) for d in devices]
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a group's devices are of one kind: {devs}")
        if devs[0].type == "cuda":
            devs = [torch.device("cuda", torch.cuda.current_device())
                    if d.index is None else d for d in devs]
        self.devices: List[torch.device] = devs
        self.n = len(devs)
        self.cap = int(cap)
        self.cuda = devs[0].type == "cuda"
        if not self.cuda:
            return
        from .._build import load

        lib = load()
        cards = sorted({d.index for d in devs})
        for a in cards:
            for b in cards:
                if a != b:
                    _raise(f"peer access {a} -> {b}",
                           lib.sx_enable_peers(a, b))
        n = self.n
        self.bufs = [torch.zeros(2 * n * self.cap, dtype=torch.int64,
                                 device=d) for d in devs]
        self.flags = [torch.zeros(n, dtype=torch.int64, device=d)
                      for d in devs]
        self.state = [torch.zeros(2, dtype=torch.int64, device=d)
                      for d in devs]
        addrs = [b.data_ptr() for b in self.bufs] + [
            f.data_ptr() for f in self.flags]
        self.ptrs = [torch.tensor(addrs, dtype=torch.int64, device=d)
                     for d in devs]


def exchange(box: ShardExchange, s: int, fpart: Optional[torch.Tensor],
             ipart: Optional[torch.Tensor], ftotal: Optional[torch.Tensor],
             itotal: Optional[torch.Tensor]) -> None:
    """Shard ``s``'s side of one exchange: its f64 partial ``fpart`` and
    int64 partial ``ipart`` (1-D, contiguous, on its device; either may be
    None) go to every shard, and ``ftotal``/``itotal`` receive the sums over
    the shards in shard order. Launches the kernel on the current stream
    (CUDA); on the CPU there is no shard-local form: the plain executor
    calls ``sum_in_order`` once every shard has reached the exchange."""
    dev = box.devices[s]
    if not box.cuda:
        raise RuntimeError("no exchange kernel for the CPU: the plain "
                           "executor sums the partials (sum_in_order)")
    args = []
    for part, total, dtype in ((fpart, ftotal, torch.float64),
                               (ipart, itotal, torch.int64)):
        if part is None:
            args += [None, 0, None]
            continue
        for t in (part, total):
            if t.dtype != dtype or t.device != dev or t.dim() != 1 \
                    or not t.is_contiguous():
                raise ValueError(f"exchange: a {dtype} 1-D contiguous "
                                 f"tensor on {dev} expected, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if total.numel() != part.numel():
            raise ValueError("exchange: total and partial differ in size")
        args += [part.data_ptr(), part.numel(), total.data_ptr()]
    wf, wi = args[1], args[4]
    if wf + wi > box.cap:
        raise ValueError(f"exchange: {wf + wi} words over a slot of "
                         f"{box.cap}")
    from .._build import load

    vp = ctypes.c_void_p
    _raise("launch", load().sx_exchange(
        dev.index, s, box.n, box.cap, vp(box.ptrs[s].data_ptr()),
        vp(box.state[s].data_ptr()), vp(args[0]), wf, vp(args[3]), wi,
        vp(args[2]), vp(args[5]), WAIT_NS, vp(CK._stream(dev))))
    _count(dev.index)
