"""Frozen copy of ``longcallr_tpu_torch/phasing/rng.py`` at commit
fbeccaa9682300b9b3ab6ff3e33e50e6f6928b91: the bits
of ``jax.random``'s PRNGKey, fold_in, split and float64 uniform, in numpy.
The transcription of the phase draws its perturbation randoms with them."""

from __future__ import annotations

from typing import Tuple

import numpy as np

_U32 = np.uint32
_MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash, 20 rounds, as jax lowers it. All arguments
    are uint32 arrays (broadcast against each other)."""
    k0 = np.asarray(k0, _U32)
    k1 = np.asarray(k1, _U32)
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0, x1 = np.broadcast_arrays(np.asarray(x0, _U32), np.asarray(x1, _U32))
    with np.errstate(over="ignore"):     # uint32 arithmetic wraps
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a 64-bit integer seed: the seed's
    bits as (high word, low word)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & _MASK32], _U32)


def _iota_2x32(n: int) -> Tuple[np.ndarray, np.ndarray]:
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(_U32), (i & np.uint64(_MASK32)).astype(_U32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in`` for one key [2] and uint32 data (scalar or
    [R]) → keys [..., 2]."""
    d = np.asarray(data).astype(np.uint64) & np.uint64(_MASK32)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(d, _U32),
                          d.astype(_U32))
    return np.stack([y0, y1], axis=-1)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (partitionable form) of keys [..., 2] →
    [..., num, 2]."""
    hi, lo = _iota_2x32(num)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return np.stack([b0, b1], axis=-1)


def uniform(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))`` in float64 for keys [..., 2] →
    [..., n]: 64 random bits per value, the top 52 as the mantissa of a
    number in [1, 2), minus 1."""
    hi, lo = _iota_2x32(n)
    b0, b1 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    bits = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    one = np.array(1.0, np.float64).view(np.uint64)
    f = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    return np.maximum(0.0, f)


def predraw_rounds(key: np.ndarray, K: int, I: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """``optimize._predraw_rounds``: for every round t < I//4+1,
    ``fold_in(key, t)`` → ``split`` → (uniform [I], uniform [K]).
    Returns ([R_max, I], [R_max, K]) float64."""
    R_max = I // 4 + 1
    kr = fold_in(key, np.arange(R_max))          # [R, 2]
    ks = split(kr)                               # [R, 2, 2]
    return uniform(ks[:, 0], I), uniform(ks[:, 1], K)
