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


# --- the redesigned matvec_cols and the thin wrappers ----------------------
# On the CPU the wrappers take the plain versions; what the card adds (row
# skipping, 16-byte loads, the scalar path, the workspace) is held against
# the plain version on the card by chip_smoke.py. Here the same inputs go
# through the wrapper and the JAX functions. Tolerance: 1e-12 relative
# against the exact f64 product (EXACT_RTOL).

def _sigma(rng, K, kind):
    s = rng.choice([-1.0, 1.0], size=K)
    if kind == "third_zero":
        s[::3] = 0.0
    elif kind == "tail_zero":
        s[K - K // 40 - 1:] = 0.0
    elif kind == "all_zero":
        s[:] = 0.0
    return s


@pytest.mark.parametrize("kind", ["third_zero", "tail_zero", "all_zero"])
@pytest.mark.parametrize("K,I", [(1024, 256), (513, 130), (200, 7)])
def test_cols_with_zero_sigma_matches_pallas_and_exact(rng, K, I, kind):
    """σ with zeros (inactive reads, the padded tail) and σ all zero, at an
    I that is and is not a multiple of 4."""
    _, hi, lo = _split(rng, (K, I))
    s = _sigma(rng, K, kind)
    want = s @ (hi.astype(np.float64) + lo.astype(np.float64))
    got = CK.matvec_cols(torch.from_numpy(hi), torch.from_numpy(lo),
                         torch.from_numpy(s)).numpy()
    assert got.shape == (I,)
    assert _rel(got, want) <= EXACT_RTOL
    if kind == "all_zero":
        assert not got.any()
    pal = PK.matvec_cols(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(s),
                         interpret=True)
    assert _rel(got, want) <= max(_rel(pal, want), 1e-9) * 1.5
    ein = JKF._matvec_cols(jnp.stack([jnp.asarray(hi), jnp.asarray(lo)]),
                           jnp.asarray(s))
    np.testing.assert_allclose(got, np.asarray(ein), rtol=0,
                               atol=2e-4 * (np.abs(want).max() + 1))


@pytest.mark.parametrize("K,I", [(64, 6), (300, 510), (96, 18)])
def test_unaligned_widths_match_pallas_and_exact(rng, K, I):
    """I not a multiple of 4 (the card's scalar path), both kernels."""
    _, hi, lo = _split(rng, (K, I))
    x2 = rng.integers(-1, 2, size=(I, 2)).astype(np.float64)
    s = rng.integers(-1, 2, size=K).astype(np.float64)
    dp = hi.astype(np.float64) + lo.astype(np.float64)
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    rows = CK.dual_matvec_rows(th, tl, torch.from_numpy(x2)).numpy()
    cols = CK.matvec_cols(th, tl, torch.from_numpy(s)).numpy()
    assert _rel(rows, dp @ x2) <= EXACT_RTOL
    assert _rel(cols, s @ dp) <= EXACT_RTOL
    pal_r = PK.dual_matvec_rows(jnp.asarray(hi), jnp.asarray(lo),
                                jnp.asarray(x2), interpret=True)
    pal_c = PK.matvec_cols(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(s),
                           interpret=True)
    assert _rel(rows, dp @ x2) <= max(_rel(pal_r, dp @ x2), 1e-9) * 1.5
    assert _rel(cols, s @ dp) <= max(_rel(pal_c, s @ dp), 1e-9) * 1.5


@pytest.mark.parametrize("shared", [True, False])
def test_batched_matvecs_match_jax_per_member(rng, shared):
    """A batch against one shared Dp or a Dp per member: each member equals
    the JAX einsum path run on that member alone."""
    B, K, I = 5, 128, 32
    _, hi, lo = _split(rng, (K, I) if shared else (B, K, I))
    x = rng.integers(-1, 2, size=(B, I, 2)).astype(np.float64)
    s = rng.integers(-1, 2, size=(B, K)).astype(np.float64)
    s[:, ::4] = 0.0
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    rows = CK.dual_matvec_rows(th, tl, torch.from_numpy(x)).numpy()
    cols = CK.matvec_cols(th, tl, torch.from_numpy(s)).numpy()
    for b in range(B):
        h, l = (hi, lo) if shared else (hi[b], lo[b])
        dp2 = jnp.stack([jnp.asarray(h), jnp.asarray(l)])
        dp = h.astype(np.float64) + l.astype(np.float64)
        scale = np.abs(dp).sum(axis=1).max() + 1
        np.testing.assert_allclose(
            rows[b], np.asarray(JKF._matvec_rows(dp2, jnp.asarray(x[b]))),
            rtol=0, atol=2e-4 * scale)
        np.testing.assert_allclose(
            cols[b], np.asarray(JKF._matvec_cols(dp2, jnp.asarray(s[b]))),
            rtol=0, atol=2e-4 * (np.abs(dp).sum(axis=0).max() + 1))
        assert _rel(rows[b], dp @ x[b]) <= EXACT_RTOL
        assert _rel(cols[b], s[b] @ dp) <= EXACT_RTOL


@pytest.mark.parametrize("case", ["strided_operand", "expanded_operand",
                                  "batch_of_one_table", "one_operand_many"])
def test_thin_and_general_wrapper_paths_give_the_same_tensor(rng, case):
    """Operands the kernels take as they are go the thin way (_usual);
    views that need a copy or a broadcast go the general way. Both give
    the same tensor, bit for bit."""
    B, K, I = 4, 64, 16
    _, hi, lo = _split(rng, (K, I))
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    x = torch.from_numpy(rng.integers(-1, 2, size=(B, I, 2)).astype(np.float64))
    s = torch.from_numpy(rng.integers(-1, 2, size=(B, K)).astype(np.float64))
    assert CK._usual(th, tl, x, 2) == (B, True)
    assert CK._usual(th, tl, s[0], 1) == (1, False)
    thin_r, thin_c = CK.dual_matvec_rows(th, tl, x), CK.matvec_cols(th, tl, s)
    if case == "strided_operand":
        x2 = torch.zeros(B, I, 4, dtype=torch.float64)[..., ::2]
        x2.copy_(x)
        s2 = torch.zeros(B, 2 * K, dtype=torch.float64)[:, ::2]
        s2.copy_(s)
        args = (th, tl, x2), (th, tl, s2)
    elif case == "expanded_operand":
        x, s = x[:1].expand(B, I, 2), s[:1].expand(B, K)
        thin_r = CK.dual_matvec_rows(th, tl, x.contiguous())
        thin_c = CK.matvec_cols(th, tl, s.contiguous())
        args = (th, tl, x), (th, tl, s)
    elif case == "batch_of_one_table":
        args = (th[None], tl[None], x), (th[None], tl[None], s)
    else:
        # one operand for a batch of tables: the operand is broadcast
        hb = torch.from_numpy(np.stack([hi] * B))
        lb = torch.from_numpy(np.stack([lo] * B))
        thin_r = CK.dual_matvec_rows(th, tl, x[0])[None].expand(B, K, 2)
        thin_c = CK.matvec_cols(th, tl, s[0])[None].expand(B, I)
        args = (hb, lb, x[0]), (hb, lb, s[0])
    assert CK._usual(*args[0], 2) is None and CK._usual(*args[1], 1) is None
    assert torch.equal(CK.dual_matvec_rows(*args[0]), thin_r)
    assert torch.equal(CK.matvec_cols(*args[1]), thin_c)


@pytest.mark.parametrize("bad", ["table_dtype", "operand_dtype", "width",
                                 "rank", "batch", "strided_table"])
def test_cols_wrapper_rejects_what_the_kernel_does_not_take(bad):
    hi, lo = torch.zeros(16, 8), torch.zeros(16, 8)
    s = torch.zeros(16, dtype=torch.float64)
    if bad == "table_dtype":
        lo = lo.double()
    elif bad == "operand_dtype":
        s = s.float()
    elif bad == "width":
        s = torch.zeros(15, dtype=torch.float64)
    elif bad == "rank":
        s = torch.zeros(2, 2, 16, dtype=torch.float64)
    elif bad == "batch":
        hi, lo = torch.zeros(3, 16, 8), torch.zeros(3, 16, 8)
        s = torch.zeros(2, 16, dtype=torch.float64)
    else:
        hi, lo = torch.zeros(16, 16)[:, ::2], torch.zeros(16, 16)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        CK.matvec_cols(hi, lo, s)


@pytest.mark.parametrize("B,K,I,aligned", [
    (1, 4096, 512, True), (64, 512, 16, True), (1, 37, 300, True),
    (1, 1025, 129, False), (1, 513, 700, True), (1, 4096, 510, True),
    (1, 4096, 512, False), (5, 300, 64, True), (1, 100000, 512, True),
    (1, 8, 4, True), (3, 1, 1, False)])
def test_cols_plan_covers_the_table(B, K, I, aligned):
    """The launch shape the wrapper hands the cols kernel: every column and
    row is covered once, the chunk is whole passes of the block within the
    kernel's staging limit, and 16-byte loads are planned only where the
    table allows them."""
    vec, tx_log2, kc, ncb, nch = CK.cols_plan(B, K, I, aligned, 132)
    assert vec == (4 if aligned and I % 4 == 0 else 1)
    width = (1 << tx_log2) * vec
    assert 0 <= tx_log2 <= CK.COLS_MAX_TX_LOG2[vec]
    assert (ncb - 1) * width < I <= ncb * width
    assert (nch - 1) * kc < K <= nch * kc
    one_pass = (CK.COLS_THREADS >> tx_log2) * CK.COLS_UNROLL
    assert kc % one_pass == 0 and one_pass <= kc <= CK.COLS_MAX_CHUNK
    if (B, K, I, aligned) == (1, 4096, 512, True):
        # the deep main-path shape: about two blocks per SM
        assert (vec, kc, ncb * nch) == (4, 128, 256)
    if (B, K, I, aligned) == (64, 512, 16, True):
        # the enumeration shape: a block's strip is small, K is not cut
        assert (vec, kc, ncb, nch) == (4, 512, 1, 1)


@pytest.mark.parametrize("I,lanes", [(1, 4), (4, 4), (5, 8), (16, 16),
                                     (17, 32), (512, 32)])
def test_rows_lanes(I, lanes):
    assert CK.rows_lanes(I) == lanes
