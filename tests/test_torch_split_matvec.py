"""Split-Dp matvecs of the torch port (cuda_kernels) vs the JAX package.

On the CPU the wrappers take their plain PyTorch versions; the same numpy
inputs go through the Pallas kernels (interpret mode) and the einsum path
of ``longcallr_tpu.phasing.kernels_fast``. The CUDA kernels themselves are
compared with the plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcallr_tpu.phasing import kernels_fast as JKF
from longcallr_tpu.phasing import pallas_kernels as PK
from longcallr_tpu_torch.phasing import cuda_kernels as CK

# plain f64 contraction of exact terms: only summation order differs from
# the exact f64 product
EXACT_RTOL = 1e-12


def _split(rng, shape):
    dp = rng.normal(size=shape) * rng.integers(0, 2, size=shape)
    hi = dp.astype(np.float32)
    lo = (dp - hi.astype(np.float64)).astype(np.float32)
    return dp, hi, lo


def _rel(got, want):
    return np.abs(np.asarray(got) - want).max() / (np.abs(want).max() + 1e-30)


SHAPES = [(1024, 256), (37, 300), (1025, 129), (8, 128), (513, 700)]


@pytest.mark.parametrize("K,I", SHAPES)
def test_rows_plain_matches_pallas_and_exact(rng, K, I):
    """dual_matvec_rows (plain on CPU) vs exact f64 (<= 1e-12 relative),
    vs the Pallas kernel in interpret mode (no worse than 1.5x its error,
    the JAX package's contract) and vs the einsum path."""
    dp, hi, lo = _split(rng, (K, I))
    x2 = rng.integers(-1, 2, size=(I, 2)).astype(np.float64)
    want = (hi.astype(np.float64) + lo.astype(np.float64)) @ x2
    got = CK.dual_matvec_rows(torch.from_numpy(hi), torch.from_numpy(lo),
                              torch.from_numpy(x2)).numpy()
    assert got.shape == (K, 2)
    port_err = _rel(got, want)
    assert port_err <= EXACT_RTOL
    pal = PK.dual_matvec_rows(jnp.asarray(hi), jnp.asarray(lo),
                              jnp.asarray(x2), interpret=True)
    assert port_err <= max(_rel(pal, want), 1e-9) * 1.5
    ein = JKF._matvec_rows(jnp.stack([jnp.asarray(hi), jnp.asarray(lo)]),
                           jnp.asarray(x2))
    # the einsum path accumulates chunks in f32 (~1e-5 relative)
    np.testing.assert_allclose(got, np.asarray(ein), rtol=0,
                               atol=2e-4 * (np.abs(want).max() + 1))


@pytest.mark.parametrize("K,I", SHAPES)
def test_cols_plain_matches_pallas_and_exact(rng, K, I):
    dp, hi, lo = _split(rng, (K, I))
    s = rng.integers(-1, 2, size=K).astype(np.float64)
    want = s @ (hi.astype(np.float64) + lo.astype(np.float64))
    got = CK.matvec_cols(torch.from_numpy(hi), torch.from_numpy(lo),
                         torch.from_numpy(s)).numpy()
    assert got.shape == (I,)
    port_err = _rel(got, want)
    assert port_err <= EXACT_RTOL
    pal = PK.matvec_cols(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(s),
                         interpret=True)
    assert port_err <= max(_rel(pal, want), 1e-9) * 1.5
    ein = JKF._matvec_cols(jnp.stack([jnp.asarray(hi), jnp.asarray(lo)]),
                           jnp.asarray(s))
    np.testing.assert_allclose(got, np.asarray(ein), rtol=0,
                               atol=2e-4 * (np.abs(want).max() + 1))


@pytest.mark.parametrize("shared", [True, False])
def test_batched_matvecs(rng, shared):
    """A batch of operands against one shared Dp (the enumeration path's
    configs) or against a Dp per batch member: each member equals its own
    unbatched contraction exactly (<= 1e-12 relative)."""
    B, K, I = 6, 96, 24
    _, hi, lo = _split(rng, (K, I) if shared else (B, K, I))
    x = rng.integers(-1, 2, size=(B, I, 2)).astype(np.float64)
    s = rng.integers(-1, 2, size=(B, K)).astype(np.float64)
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    rows = CK.dual_matvec_rows(th, tl, torch.from_numpy(x)).numpy()
    cols = CK.matvec_cols(th, tl, torch.from_numpy(s)).numpy()
    assert rows.shape == (B, K, 2) and cols.shape == (B, I)
    for b in range(B):
        dp = (hi if shared else hi[b]).astype(np.float64) + \
            (lo if shared else lo[b]).astype(np.float64)
        assert _rel(rows[b], dp @ x[b]) <= EXACT_RTOL
        assert _rel(cols[b], s[b] @ dp) <= EXACT_RTOL


def test_cpu_calls_do_not_count_launches(rng):
    """Only kernel launches count; the CPU path runs the plain version."""
    _, hi, lo = _split(rng, (16, 8))
    before = dict(CK.LAUNCHES)
    CK.dual_matvec_rows(torch.from_numpy(hi), torch.from_numpy(lo),
                        torch.zeros(8, 2, dtype=torch.float64))
    CK.matvec_cols(torch.from_numpy(hi), torch.from_numpy(lo),
                   torch.zeros(16, dtype=torch.float64))
    assert CK.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype_split", "dtype_operand", "shape",
                                 "device"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    hi = torch.zeros(16, 8)
    lo = torch.zeros(16, 8)
    x = torch.zeros(8, 2, dtype=torch.float64)
    if bad == "dtype_split":
        hi = hi.double()
    elif bad == "dtype_operand":
        x = x.float()
    elif bad == "shape":
        x = torch.zeros(9, 2, dtype=torch.float64)
    else:
        # neither CPU nor CUDA: no plain fallback, no kernel — it raises
        hi, lo, x = hi.to("meta"), lo.to("meta"), x.to("meta")
    with pytest.raises((TypeError, ValueError, RuntimeError)):
        CK.dual_matvec_rows(hi, lo, x)
