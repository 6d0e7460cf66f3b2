"""The perturbation schedule's round draws: a CUDA kernel + its plain version.

The JAX package draws every round's randoms of the schedule on the device,
inside its compiled phase programs (``longcallr_tpu/parallel/mesh.py:224-232``
for a bucket, ``longcallr_tpu/phasing/optimize.py:381-397`` for one region):
per region key and round t,
``fold_in(key, t)`` → ``split`` → ``uniform [I]`` and ``uniform [K]`` in
float64, under ``jax_threefry_partitionable=True``. ``round_draws`` makes
the same draws for a bucket of keys in one launch of the hand-written kernel
of ``csrc/round_draws.cu`` (built at first use, see ``_build.py``), round
first, as ``optimize._schedule_loop`` indexes them. ``rng.py`` holds the
host numpy reference of the same bits.

The draws are integer work, so the kernel and the plain version agree bit
for bit. Element i of a draw depends only on i and its key, and round t
only on t: the first m values of a draw of length n are a draw of length m,
and a caller may draw fewer rounds than the JAX package's ``I // 4 + 1``
and get the same bits for them. The schedule draws all ``I // 4 + 1`` at
the padded widths, as the JAX package does, and reads round t's draws at
min(t, I // 4): a round past them reuses the last, as JAX's clamped
dynamic index does.

The plain version computes the hashes in int64 tensors masked to 32 bits:
torch's uint32 has no shifts on the CPU.

``DRAW_LAUNCHES`` counts kernel launches (plain-version calls are not
counted), ``DRAW_LAUNCHES_BY_ROW`` the same per row of a regions mesh, for
the row that ``cuda_kernels.set_launch_row`` named for the launching thread,
and ``DRAW_LAUNCH_SHAPES`` holds the (keys, rounds, I, K) of the launches.
``cuda_kernels.reset_launches`` clears all three. The schedule's device
program (``phasing/graphs.py``) draws into buffers of its own (``out=``)
inside its first piece: under capture a launch is recorded, as the matvec
wrappers' are (``cuda_kernels.recording``), and counted at every run of the
program.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

import numpy as np
import torch

from . import cuda_kernels as CK

DRAW_LAUNCHES = {"round_draws": 0}
DRAW_LAUNCHES_BY_ROW: Dict[int, int] = {}
DRAW_LAUNCH_SHAPES: Set[Tuple[int, int, int, int]] = set()

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3FF0000000000000      # the bits of 1.0 in float64


def reset_draw_launches() -> None:
    with CK._count_lock:
        DRAW_LAUNCHES["round_draws"] = 0
        DRAW_LAUNCHES_BY_ROW.clear()
        DRAW_LAUNCH_SHAPES.clear()


def add_draw_launches(shape: Tuple[int, int, int, int], n: int = 1) -> None:
    """Count ``n`` launches at ``shape`` for this thread's row (the caller
    holds ``cuda_kernels._count_lock``)."""
    row = getattr(CK._launch_row, "index", None)
    DRAW_LAUNCHES["round_draws"] += n
    DRAW_LAUNCH_SHAPES.add(shape)
    if row is not None:
        DRAW_LAUNCHES_BY_ROW[row] = DRAW_LAUNCHES_BY_ROW.get(row, 0) + n


def _count(shape: Tuple[int, int, int, int], device_index: int) -> None:
    rec = getattr(CK._recorded, "launches", None)
    if rec is not None:
        rec.append(("round_draws", shape, device_index))
        return
    with CK._count_lock:
        add_draw_launches(shape)


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors (or ints) that hold
    uint32 words, broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _uniform(k0, k1, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in float64 for keys (k0, k1) of
    any shape → [..., n]."""
    i = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = _threefry(k0[..., None], k1[..., None], i >> 32, i & _M32)
    bits = (b0 << 20) | (b1 >> 12) | _ONE_BITS
    return (bits.view(torch.float64) - 1.0).clamp_min(0.0)


def key_words(keys, device) -> torch.Tensor:
    """Threefry keys (``rng.prng_key``: one [2], or [B, 2] as an array or a
    sequence of keys) as the int64 tensor of their uint32 words that
    ``round_draws`` takes, on ``device``."""
    return torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                           device=device)


def _check(keys: torch.Tensor, n_rounds: int, I: int, K: int) -> None:
    if keys.dtype is not torch.int64:
        raise TypeError(f"keys must be int64 (uint32 words), got {keys.dtype}")
    if keys.dim() not in (1, 2) or keys.shape[-1] != 2:
        raise ValueError(f"keys must be [2] or [B, 2], got {tuple(keys.shape)}")
    if min(n_rounds, I, K) < 0:
        raise ValueError(f"negative size: rounds {n_rounds}, I {I}, K {K}")


def round_draws_plain(keys: torch.Tensor, n_rounds: int, I: int, K: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``round_draws``, on the keys' device."""
    _check(keys, n_rounds, I, K)
    k = keys.reshape(-1, 2) & _M32
    t = torch.arange(n_rounds, dtype=torch.int64, device=keys.device)[:, None]
    r0, r1 = _threefry(k[:, 0], k[:, 1], 0, t)              # fold_in [R, B]
    a0, a1 = _threefry(r0, r1, 0, 0)                        # split
    b0, b1 = _threefry(r0, r1, 0, 1)
    rg, fl = _uniform(a0, a1, I), _uniform(b0, b1, K)
    if keys.dim() == 1:
        return rg[:, 0], fl[:, 0]
    return rg, fl


def _out(out, shapes, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The result tensors: new ones, or ``out`` checked against them."""
    if out is None:
        return tuple(torch.empty(s, dtype=torch.float64, device=dev)
                     for s in shapes)
    for o, s in zip(out, shapes):
        if (o.dtype is not torch.float64 or tuple(o.shape) != s
                or o.device != dev or not o.is_contiguous()):
            raise ValueError(f"out must be contiguous float64 {s} on {dev}, "
                             f"got {o.dtype} {tuple(o.shape)} on {o.device}")
    return tuple(out)


def round_draws(keys: torch.Tensor, n_rounds: int, I: int, K: int,
                out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``n_rounds`` rounds of the schedule's draws for each key:
    keys int64 [B, 2] (the uint32 words of ``rng.prng_key``, one key per
    region) → (rg [R, B, I], fl [R, B, K]) float64, R = n_rounds; keys [2]
    → ([R, I], [R, K]). ``out``: the two result tensors to write (a device
    program's buffers). On a CPU tensor the plain version; on a CUDA tensor
    the kernel on the current stream (one launch as a rule; more keys or
    rounds than a grid dimension holds take more), or an error."""
    n_rounds, I, K = int(n_rounds), int(I), int(K)
    _check(keys, n_rounds, I, K)
    B = keys.shape[0] if keys.dim() == 2 else 1
    lead = (n_rounds, B) if keys.dim() == 2 else (n_rounds,)
    if keys.device.type == "cpu":
        if out is None:
            return round_draws_plain(keys, n_rounds, I, K)
        rg, fl = _out(out, (lead + (I,), lead + (K,)), keys.device)
        for o, v in zip((rg, fl), round_draws_plain(keys, n_rounds, I, K)):
            o.copy_(v)
        return rg, fl
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
    dev = CK._cuda_device(keys)
    rg, fl = _out(out, (lead + (I,), lead + (K,)), dev)
    if n_rounds and B and I + K:
        from .._build import load
        err = load().round_draws(keys.data_ptr(), rg.data_ptr(), fl.data_ptr(),
                                 B, n_rounds, I, K, dev.index, CK._stream(dev))
        if err != 0:
            raise RuntimeError(f"round_draws launch failed: cudaError {err}")
        _count((B, n_rounds, I, K), dev.index)
    return rg, fl
