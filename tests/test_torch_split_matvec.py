"""Split-Dp matvecs of the torch port (cuda_kernels) vs the JAX package.

On the CPU the wrappers take their plain PyTorch versions; the same numpy
inputs go through the Pallas kernels (interpret mode) and the einsum path
of ``longcallr_tpu.phasing.kernels_fast``. The CUDA kernels themselves are
compared with the plain versions on the card by ``chip_smoke.py``.
"""

import sys
import threading

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


def _saved_launch_record():
    return (dict(CK.LAUNCHES), {k: set(v) for k, v in CK.LAUNCH_SHAPES.items()},
            {k: dict(v) for k, v in CK.LAUNCHES_BY_DEVICE.items()},
            {k: dict(v) for k, v in CK.LAUNCHES_BY_ROW.items()})


def _restore_launch_record(saved):
    CK.LAUNCHES.update(saved[0])
    for k, v in saved[1].items():
        CK.LAUNCH_SHAPES[k] = v
    for table, old in zip((CK.LAUNCHES_BY_DEVICE, CK.LAUNCHES_BY_ROW),
                          saved[2:]):
        table.clear()
        table.update(old)


def test_launch_record_counts_and_shapes():
    """A launch is recorded under (tables, K, I, members per table) and
    under its card, and reset_launches clears counts, shapes and the
    per-card and per-row counts."""
    saved = _saved_launch_record()
    try:
        CK.reset_launches()
        assert CK.LAUNCHES == {"dual_matvec_rows": 0, "matvec_cols": 0}
        assert all(not v for v in CK.LAUNCH_SHAPES.values())
        CK._count("matvec_cols", torch.zeros(12, 64, 8), 16, 0)
        CK._count("matvec_cols", torch.zeros(12, 64, 8), 16, 1)
        CK._count("dual_matvec_rows", torch.zeros(64, 8), 16, 0)
        assert CK.LAUNCHES == {"dual_matvec_rows": 1, "matvec_cols": 2}
        assert CK.LAUNCH_SHAPES == {"dual_matvec_rows": {(1, 64, 8, 16)},
                                    "matvec_cols": {(12, 64, 8, 16)}}
        assert CK.LAUNCHES_BY_DEVICE == {
            0: {"dual_matvec_rows": 1, "matvec_cols": 1},
            1: {"dual_matvec_rows": 0, "matvec_cols": 1}}
        assert CK.LAUNCHES_BY_ROW == {}       # no mesh row named
        CK.reset_launches()
        assert all(not v for v in CK.LAUNCH_SHAPES.values())
        assert not CK.LAUNCHES_BY_DEVICE
    finally:
        _restore_launch_record(saved)


def test_launches_are_counted_by_mesh_row_across_threads():
    """Threads that name their mesh row (set_launch_row) are counted per
    row, on one card too; eight threads with a short switch interval lose
    no count, and reset_launches clears the rows."""
    saved = _saved_launch_record()
    interval = sys.getswitchinterval()
    hi = torch.zeros(2, 16, 8)
    try:
        CK.reset_launches()
        sys.setswitchinterval(1e-6)
        start = threading.Barrier(8, timeout=30)

        def row(r: int) -> None:
            CK.set_launch_row(r % 4)
            start.wait()
            for _ in range(250):
                CK._count("dual_matvec_rows", hi, 1, 0)
                CK._count("matvec_cols", hi, 1, 0)
            CK.set_launch_row(None)

        threads = [threading.Thread(target=row, args=(r,)) for r in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        CK._count("matvec_cols", hi, 1, 0)     # this thread names no row
        assert CK.LAUNCHES == {"dual_matvec_rows": 2000, "matvec_cols": 2001}
        assert CK.LAUNCHES_BY_DEVICE == {
            0: {"dual_matvec_rows": 2000, "matvec_cols": 2001}}
        assert CK.LAUNCHES_BY_ROW == {
            r: {"dual_matvec_rows": 500, "matvec_cols": 500}
            for r in range(4)}
        CK.reset_launches()
        assert not CK.LAUNCHES_BY_ROW and not CK.LAUNCHES_BY_DEVICE
    finally:
        sys.setswitchinterval(interval)
        _restore_launch_record(saved)


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
    """Operands the kernels take as they are are handed on uncopied; views
    that need a copy or a broadcast are made contiguous first. Both give
    the same tensor, bit for bit."""
    B, K, I = 4, 64, 16
    _, hi, lo = _split(rng, (K, I))
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    x = torch.from_numpy(rng.integers(-1, 2, size=(B, I, 2)).astype(np.float64))
    s = torch.from_numpy(rng.integers(-1, 2, size=(B, K)).astype(np.float64))
    assert CK._operands(th, tl, x, 2) == (B, B, x, (B,))
    assert CK._operands(th, tl, x, 2)[2] is x
    assert CK._operands(th, tl, s[0], 1)[:2] == (1, 1)
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
    if case != "batch_of_one_table":
        assert CK._operands(*args[0], 2)[2] is not args[0][2]
        assert CK._operands(*args[1], 1)[2] is not args[1][2]
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


@pytest.mark.parametrize("tables,K,I,g,want", [
    (4, 512, 16, 64, (8, 0, 4)), (4, 512, 16, 512, (8, 0, 32)),
    (1, 512, 16, 1024, (8, 0, 16)), (64, 8, 16, 1024, (3, 5, 512)),
    (12, 64, 8, 16, (6, 2, 4)), (1, 64, 8, 16, (6, 2, 4)),
    (4, 512, 8, 64, (8, 0, 4)), (1, 512, 8, 64, (8, 0, 1)),
    (1, 4096, 512, 1, (3, 0, 1)), (3, 200, 24, 5, (8, 0, 1)),
    (100, 64, 16, 1, (6, 0, 1)), (1, 1, 1, 1, (3, 0, 1)),
    (2, 40, 600, 70, (3, 0, 6)), (1, 8, 16, 1 << 17, (3, 5, 1024)),
    (4096, 8, 8, 64, (3, 5, 64))])
def test_rows_plan_covers_every_member(tables, K, I, g, want):
    """The launch shape the wrapper hands the rows kernel: a block is at
    most 256 threads, row threads by member ways; one thread per row up to
    32 cells, a warp per row beyond; the chunks of a table's members cover
    all g, in whole turns of the ways, and on an H100's 132 SMs there are
    no more chunks than SMs."""
    rt_log2, ways_log2, mb = CK.rows_plan(tables, K, I, g, 132)
    assert (rt_log2, ways_log2, mb) == want
    ways = 1 << ways_log2
    assert 3 <= rt_log2 <= 8 and rt_log2 + ways_log2 <= 8
    assert 1 <= mb <= g and (mb % ways == 0 or mb == g)
    if I <= CK.ROWS_WALK_MAX_I:
        assert (1 << rt_log2) >= min(K, 256) and ways <= max(1, g)
    else:
        assert (1 << rt_log2, ways) == (CK.ROWS_LANE_ROWS, 1)
    chunks = -(-g // mb)
    assert (chunks - 1) * mb < g <= chunks * mb
    # the chunks lie on the grid's second dimension: a few per SM, whatever
    # the number of members
    assert chunks <= max(1, CK.ROWS_BLOCKS_PER_SM * 132)


# --- members per table: a bucket of regions with C configs each -------------
# Tables [B,K,I] with an operand [B,C,...]: member (b, c) reads table b. The
# kernels take the members flat with the members per table; on the CPU the
# plain versions take the same shapes. Each member is held against the JAX
# kernels run on that member alone (Pallas in interpret mode within 1.5x of
# its error; the einsum path to its f32 chunk bound).

@pytest.mark.parametrize("B,C,K,I", [(4, 64, 512, 16), (3, 5, 96, 24),
                                     (2, 1, 40, 7), (1, 6, 64, 12)])
def test_members_per_table_match_jax_per_member(rng, B, C, K, I):
    _, hi, lo = _split(rng, (B, K, I))
    x = rng.integers(-1, 2, size=(B, C, I, 2)).astype(np.float64)
    s = rng.integers(-1, 2, size=(B, C, K)).astype(np.float64)
    s[..., ::5] = 0.0
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    rows = CK.dual_matvec_rows(th, tl, torch.from_numpy(x)).numpy()
    cols = CK.matvec_cols(th, tl, torch.from_numpy(s)).numpy()
    assert rows.shape == (B, C, K, 2) and cols.shape == (B, C, I)
    for b in range(B):
        dp = hi[b].astype(np.float64) + lo[b].astype(np.float64)
        dp2 = jnp.stack([jnp.asarray(hi[b]), jnp.asarray(lo[b])])
        for c in range(0, C, max(1, C // 3)):
            want_r, want_c = dp @ x[b, c], s[b, c] @ dp
            assert _rel(rows[b, c], want_r) <= EXACT_RTOL
            assert _rel(cols[b, c], want_c) <= EXACT_RTOL
            np.testing.assert_allclose(
                rows[b, c],
                np.asarray(JKF._matvec_rows(dp2, jnp.asarray(x[b, c]))),
                rtol=0, atol=2e-4 * (np.abs(dp).sum(axis=1).max() + 1))
            np.testing.assert_allclose(
                cols[b, c],
                np.asarray(JKF._matvec_cols(dp2, jnp.asarray(s[b, c]))),
                rtol=0, atol=2e-4 * (np.abs(dp).sum(axis=0).max() + 1))
    # one member through the Pallas kernels (interpret mode)
    dp = hi[0].astype(np.float64) + lo[0].astype(np.float64)
    pal_r = PK.dual_matvec_rows(jnp.asarray(hi[0]), jnp.asarray(lo[0]),
                                jnp.asarray(x[0, 0]), interpret=True)
    pal_c = PK.matvec_cols(jnp.asarray(hi[0]), jnp.asarray(lo[0]),
                           jnp.asarray(s[0, 0]), interpret=True)
    assert _rel(rows[0, 0], dp @ x[0, 0]) <= \
        max(_rel(pal_r, dp @ x[0, 0]), 1e-9) * 1.5
    assert _rel(cols[0, 0], s[0, 0] @ dp) <= \
        max(_rel(pal_c, s[0, 0] @ dp), 1e-9) * 1.5


@pytest.mark.parametrize("which", ["wrapper", "plain"])
def test_members_per_table_argument_names_a_flat_operand(rng, which):
    """A flat operand [B·g, ...] with members_per_table=g is the operand
    [B, g, ...]: the same numbers, flat."""
    B, g, K, I = 3, 4, 48, 12
    _, hi, lo = _split(rng, (B, K, I))
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    x = torch.from_numpy(rng.integers(-1, 2, size=(B, g, I, 2)).astype(np.float64))
    s = torch.from_numpy(rng.integers(-1, 2, size=(B, g, K)).astype(np.float64))
    rows_fn, cols_fn = ((CK.dual_matvec_rows, CK.matvec_cols)
                        if which == "wrapper" else
                        (CK.dual_matvec_rows_plain, CK.matvec_cols_plain))
    rows = rows_fn(th, tl, x.reshape(B * g, I, 2), members_per_table=g)
    cols = cols_fn(th, tl, s.reshape(B * g, K), members_per_table=g)
    assert rows.shape == (B * g, K, 2) and cols.shape == (B * g, I)
    assert torch.equal(rows.reshape(B, g, K, 2), rows_fn(th, tl, x))
    assert torch.equal(cols.reshape(B, g, I), cols_fn(th, tl, s))
    # g = 1 and g = all are the two older forms
    assert torch.equal(rows_fn(th, tl, x[:, 0].contiguous(),
                               members_per_table=1), rows_fn(th, tl, x[:, 0]))
    assert torch.equal(cols_fn(th[:1], tl[:1], s[0].contiguous(),
                               members_per_table=g), cols_fn(th[0], tl[0], s[0]))


def test_operands_report_members_and_members_per_table():
    hi, lo = torch.zeros(3, 16, 8), torch.zeros(3, 16, 8)
    f64 = torch.float64
    x = torch.zeros(3, 5, 8, 2, dtype=f64)
    assert CK._operands(hi, lo, x, 2)[:2] == (15, 5)
    assert CK._operands(hi, lo, x, 2)[3] == (3, 5)
    assert CK._operands(hi, lo, x[:, 0].contiguous(), 2)[:2] == (3, 1)
    assert CK._operands(hi[0], lo[0], x[0], 2)[:2] == (5, 5)
    assert CK._operands(hi[:1], lo[:1], x[0], 2)[:2] == (5, 5)
    assert CK._operands(hi, lo, torch.zeros(16, dtype=f64), 1)[:2] == (3, 1)
    assert CK._operands(hi, lo, torch.zeros(6, 16, dtype=f64), 1,
                        members_per_table=2)[:2] == (6, 2)


@pytest.mark.parametrize("bad", ["zero", "not_a_multiple", "with_two_axes",
                                 "tables_mismatch", "three_axes",
                                 "two_axes_one_table"])
def test_members_per_table_rejects_what_does_not_fit(bad):
    hi, lo = torch.zeros(3, 16, 8), torch.zeros(3, 16, 8)
    s = torch.zeros(6, 16, dtype=torch.float64)
    kw = {"members_per_table": 2}
    if bad == "zero":
        kw = {"members_per_table": 0}
    elif bad == "not_a_multiple":
        s = torch.zeros(7, 16, dtype=torch.float64)
    elif bad == "with_two_axes":
        s = torch.zeros(3, 2, 16, dtype=torch.float64)
    elif bad == "tables_mismatch":
        s, kw = torch.zeros(2, 4, 16, dtype=torch.float64), {}
    elif bad == "three_axes":
        s, kw = torch.zeros(3, 2, 2, 16, dtype=torch.float64), {}
    else:
        hi, lo, kw = hi[0], lo[0], {}
        s = torch.zeros(3, 2, 16, dtype=torch.float64)
    with pytest.raises(ValueError):
        CK.matvec_cols(hi, lo, s, **kw)


def test_cols_plan_for_a_deep_bucket():
    """Four deep tables with one member each: the grid still lands near two
    blocks per SM, and the workspace the wrapper asks for covers every
    member's partials and tickets."""
    vec, tx_log2, kc, ncb, nch = CK.cols_plan(4, 4096, 512, True, 132)
    assert (vec, kc, ncb, nch) == (4, 512, 8, 8)
    blocks = 4 * ncb * nch
    assert 1.5 <= blocks / 132 <= 2.5
    # what matvec_cols hands _workspace: B·nch·I partials, B·ncb tickets
    assert (4 * nch * 512, 4 * ncb) == (16384, 32)
    # an enumeration bucket: 256 members over 4 small tables, K is not cut
    assert CK.cols_plan(256, 512, 16, True, 132)[3:] == (1, 1)


# --- the enumeration shapes a run launches -----------------------------------
# A 6-SNP bucket (I = 8, 64 configs), a 10-SNP bucket as the batched path chunks it
# (I = 16, 512 configs a launch), one 10-SNP region's 1,024 configs, and 64
# regions of 8 reads with 1,024 configs each: 65,536 members, more than the
# second or third dimension of a CUDA grid holds. Tolerance: 1e-12 relative on
# the f64 sums against the exact product (only the order of summation
# differs); the JAX einsum forms to their own f32 chunk bound.

ENUM_SHAPES = [(4, 512, 8, 64), (4, 512, 16, 512), (1, 512, 16, 1024),
               (64, 8, 16, 1024)]


def _enum_inputs(rng, tables, K, I, g):
    _, hi, lo = _split(rng, (tables, K, I))
    x = rng.integers(-1, 2, size=(tables * g, I, 2)).astype(np.float64)
    s = rng.integers(-1, 2, size=(tables * g, K)).astype(np.float64)
    s[:, ::5] = 0.0
    return hi, lo, x, s


@pytest.mark.parametrize("which", ["wrapper", "plain"])
@pytest.mark.parametrize("tables,K,I,g", ENUM_SHAPES)
def test_enumeration_shapes_match_jax_and_exact(rng, tables, K, I, g, which):
    hi, lo, x, s = _enum_inputs(rng, tables, K, I, g)
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    rows_fn, cols_fn = ((CK.dual_matvec_rows, CK.matvec_cols)
                        if which == "wrapper" else
                        (CK.dual_matvec_rows_plain, CK.matvec_cols_plain))
    rows = rows_fn(th, tl, torch.from_numpy(x), members_per_table=g).numpy()
    cols = cols_fn(th, tl, torch.from_numpy(s), members_per_table=g).numpy()
    M = tables * g
    assert rows.shape == (M, K, 2) and cols.shape == (M, I)
    dp = hi.astype(np.float64) + lo.astype(np.float64)
    # every member against the exact f64 product
    want_r = np.einsum("tki,tgic->tgkc", dp, x.reshape(tables, g, I, 2))
    want_c = np.einsum("tgk,tki->tgi", s.reshape(tables, g, K), dp)
    assert _rel(rows, want_r.reshape(M, K, 2)) <= EXACT_RTOL
    assert _rel(cols, want_c.reshape(M, I)) <= EXACT_RTOL
    # members at both ends of a table and of the batch through the JAX forms
    for m in sorted({0, g - 1, M // 2, M - 1}):
        t = m // g
        dp2 = jnp.stack([jnp.asarray(hi[t]), jnp.asarray(lo[t])])
        np.testing.assert_allclose(
            rows[m], np.asarray(JKF._matvec_rows(dp2, jnp.asarray(x[m]))),
            rtol=0, atol=2e-4 * (np.abs(dp[t]).sum(axis=1).max() + 1))
        np.testing.assert_allclose(
            cols[m], np.asarray(JKF._matvec_cols(dp2, jnp.asarray(s[m]))),
            rtol=0, atol=2e-4 * (np.abs(dp[t]).sum(axis=0).max() + 1))
    # the last member through the Pallas kernels (interpret mode)
    m, t = M - 1, tables - 1
    pal_r = PK.dual_matvec_rows(jnp.asarray(hi[t]), jnp.asarray(lo[t]),
                                jnp.asarray(x[m]), interpret=True)
    pal_c = PK.matvec_cols(jnp.asarray(hi[t]), jnp.asarray(lo[t]),
                           jnp.asarray(s[m]), interpret=True)
    assert _rel(rows[m], dp[t] @ x[m]) <= \
        max(_rel(pal_r, dp[t] @ x[m]), 1e-9) * 1.5
    assert _rel(cols[m], s[m] @ dp[t]) <= \
        max(_rel(pal_c, s[m] @ dp[t]), 1e-9) * 1.5


@pytest.mark.parametrize("tables,K,I,g", ENUM_SHAPES + [(3, 200, 24, 5)])
def test_rows_member_among_g_equals_member_alone_exactly(rng, tables, K, I, g):
    """A member's rows result with g members per table is its result alone
    on its table, bit for bit: batched, per-region and one-config runs can
    then write equal bytes."""
    hi, lo, x, _ = _enum_inputs(rng, tables, K, I, g)
    th, tl = torch.from_numpy(hi), torch.from_numpy(lo)
    rows = CK.dual_matvec_rows(th, tl, torch.from_numpy(x),
                               members_per_table=g)
    M = tables * g
    for m in sorted({0, 1, g - 1, g % M, M // 2, M - 1}):
        alone = CK.dual_matvec_rows(th[m // g], tl[m // g],
                                    torch.from_numpy(x[m]))
        assert torch.equal(rows[m], alone)


def test_operands_accept_more_members_than_a_grid_dimension_holds():
    """65,536 members (64 regions x 1,024 configs) are legal operands of
    both wrappers, flat or as [tables, members, ...]."""
    hi, lo = torch.zeros(64, 8, 16), torch.zeros(64, 8, 16)
    x = torch.zeros(65536, 16, 2, dtype=torch.float64)
    s = torch.zeros(64, 1024, 8, dtype=torch.float64)
    M, g, xc, lead = CK._operands(hi, lo, x, 2, members_per_table=1024)
    assert (M, g, lead) == (65536, 1024, (65536,)) and xc is x
    assert CK._operands(hi, lo, s, 1)[:2] == (65536, 1024)
    assert CK._operands(hi[0], lo[0], x, 2)[:2] == (65536, 65536)
    assert CK.dual_matvec_rows(hi, lo, x, members_per_table=1024).shape == \
        (65536, 8, 2)
    assert CK.matvec_cols(hi, lo, s).shape == (64, 1024, 16)


# --- the cols walk: members that share a table (I <= 32) --------------------
# A block walks mb members of one table; the table streams through shared
# memory in stages of 64-row tiles, and each member's sum is its tiles'
# partials (each an f64 chain from 0) added in row order. The plan decides
# how many members a block walks, how many ways split a stage's tiles and
# how many tiles a stage holds; none of it may change a member's order.

WALK_PLAN_SHAPES = [
    # the enumeration shapes the main path launches (tables, K, I, g)
    (4, 512, 16, 512), (1, 1024, 16, 1024), (6, 1024, 16, 128),
    (1, 64, 8, 8), (12, 64, 8, 16), (1, 64, 8, 16), (4, 512, 8, 64),
    (1, 512, 8, 64), (1, 512, 16, 1024),
    # 65,536 members in one launch, and more tables than grid.y holds
    (64, 8, 16, 1024), (70000, 64, 8, 2),
    # one member per table at I <= 32, odd widths, tiny I with many members
    (4, 1024, 16, 1), (1, 100000, 16, 1), (3, 200, 24, 5), (2, 300, 30, 6),
    (7, 100, 12, 3), (3, 50, 5, 9), (1, 8, 1, 1 << 17), (1, 8, 4, 1 << 17),
    (2, 300, 32, 6),
    # the first width past the walk, and the deep shapes: the strip
    (1, 512, 33, 64), (1, 512, 33, 1), (4, 4096, 512, 1), (2, 4096, 512, 1),
    (5, 2048, 256, 1)]


@pytest.mark.parametrize("tables,K,I,g", WALK_PLAN_SHAPES)
def test_cols_walk_plan_covers_every_member(tables, K, I, g):
    """The path is the walk for I <= 32 at every g (one member alone on its
    table takes it too, so that its sum runs in the same order as among
    g) and the strip beyond; on the walk every member of a table falls in
    exactly one chunk, the direct form serves one member per table and
    calls of few members, the grid's dimensions stay within CUDA's
    limits, a block within 256 threads and its shared memory within an
    H100's 232,448 bytes."""
    assert CK.cols_path(I) == ("walk" if I <= 32 else "strip")
    if CK.cols_path(I) == "strip":
        vec, tx_log2, kc, ncb, nch = CK.cols_plan(tables * g, K, I, True,
                                                  132)
        assert nch <= 65535
        return
    vec, rm, mb, ways, stage_tiles, bufs, cl = CK.cols_walk_plan(
        tables, K, I, g, 132)
    assert vec in (1, 2) and I % vec == 0
    assert 1 <= mb <= g and ways >= 1 and cl in (1, 2, 4, 8, 16)
    threads = CK.cols_walk_threads(I, vec, rm, mb, ways)
    assert threads <= CK.COLS_WALK_THREADS
    shared = CK.cols_walk_shared_bytes(K, I, mb, ways, stage_tiles, bufs)
    assert shared <= 232448
    per_tile = CK.COLS_WALK_TILE // CK.COLS_WALK_CHAIN
    if mb == 1:                             # the direct form
        assert ways % per_tile == 0
        assert ways <= max(per_tile, per_tile * -(-K // CK.COLS_WALK_TILE))
        # a cluster a member: g * cl CTAs on grid.x, no more than the SMs
        assert tables * cl <= max(132, tables)
    else:                                   # a way a chain of a stage
        assert rm in (1, 2, 4) and mb % rm == 0
        assert 1 <= ways <= per_tile * stage_tiles and 1 <= bufs <= 4
        assert cl == 1 and (ways == 1 or mb * I <= 16 * threads)
    chunks = -(-g // mb)
    # the chunks [j*mb, (j+1)*mb) cover 0 .. g-1 once
    covered = np.zeros(g, dtype=np.int64)
    for j in range(chunks):
        covered[j * mb:min(g, (j + 1) * mb)] += 1
    assert (covered == 1).all()
    # grid (chunks, tables a launch): chunks on x, tables 65,535 a launch
    assert chunks <= 2 ** 31 - 1
    launches = -(-tables // 65535)
    assert all(min(65535, tables - t0) <= 65535
               for t0 in range(0, tables, 65535))
    assert launches == (2 if tables == 70000 else 1)
    # no more chunks a table than fill the card, where shared memory and
    # the block's threads let a block walk that many members
    wanted = max(1, CK.COLS_WALK_BLOCKS_PER_SM * 132 // tables)
    if mb >= -(-g // wanted):
        assert chunks <= wanted
    # the direct form, each member alone, for one member per table or few
    # members in all; else a few members a block at least
    assert (mb == 1) == (g == 1 or tables * g
                         <= CK.COLS_WALK_DIRECT_MEMBERS_PER_SM * 132)
    if 1 < mb < g:
        assert mb >= min(g, CK.COLS_WALK_MIN_MEMBERS)


def _chain(dp, s, mem, t, k0, k1):
    """One chain's partial: rows k0 .. k1-1 in order from 0."""
    c = np.zeros((len(mem), dp.shape[2]))
    for k in range(k0, k1):
        c = c + s[mem, k][:, None] * dp[t, k]
    return c


def _walk_emulate(dp, s, g, plan, stage_rows=None):
    """The walk's arithmetic on the CPU, as its kernels run it.

    Staged (mb > 1), per chunk of mb members: stages of SR rows (the
    kernel's WalkLayout: stage_tiles tiles, or K rounded up to even where
    one stage holds K; ``stage_rows`` sets another SR); way w sums the
    stage's chains w, w + ways, ... of 16 rows. With one way the thread
    adds each chain into its tile and the tile into its sum at a tile's
    last chain or the stage's; with more, the chains' partials go to
    shared memory and each sum is folded from there, a tile's 4 chains at
    a time. Direct (mb = 1): rounds of cl * ways chains; thread w of CTA r
    sums chain q + r * ways + w, the tile's first thread adds the tile's
    chains, and CTA 0 adds the round's tiles in (CTA, tile) order. σ holds
    -1, 0, 1, so each product is exact and ``c + s*d`` rounds once, as the
    kernels' fma does."""
    _, _, mb, ways, stage_tiles, _, cl = plan
    tables, K, I = dp.shape
    C = CK.COLS_WALK_CHAIN
    per = CK.COLS_WALK_TILE // C
    out = np.zeros((tables * g, I))
    for t in range(tables):
        for j0 in range(0, g, mb):
            mem = np.arange(t * g + j0, t * g + min(g, j0 + mb))
            zero = np.zeros((len(mem), I))
            tot = zero
            chain = lambda x: _chain(dp, s, mem, t, x * C, min(K, x * C + C))
            if mb == 1:
                n_chains = -(-K // C)
                tpc = ways // per
                for q in range(0, n_chains, cl * ways):
                    tp = {}
                    for r in range(cl):
                        base = q + r * ways
                        pt = {w: chain(base + w) for w in range(ways)
                              if base + w < n_chains}
                        for w in range(0, ways, per):
                            if base + w >= n_chains:
                                continue
                            tile = zero
                            for x in range(w, min(w + per,
                                                  w + n_chains - base - w)):
                                tile = tile + pt[x]
                            tp[r * tpc + w // per] = tile
                    for u in range(min(-(-(n_chains - q) // per), cl * tpc)):
                        tot = tot + tp[u]
                out[mem] = tot
                continue
            sr = stage_rows or CK._walk_stage_rows(K, stage_tiles)
            for r0 in range(0, K, sr):
                chains = -(-min(sr, K - r0) // C)
                parts = [_chain(dp, s, mem, t, r0 + x * C,
                                min(K, r0 + x * C + C))
                         for x in range(chains)]
                if ways == 1:
                    tile = zero
                    for x in range(chains):
                        tile = tile + parts[x]
                        if x % per == per - 1 or x == chains - 1:
                            tot, tile = tot + tile, zero
                else:
                    for x0 in range(0, chains, per):
                        tile = zero
                        for p in parts[x0:x0 + per]:
                            tile = tile + p
                        tot = tot + tile
            out[mem] = tot
    return out


def _walk_case(rng, tables, K, I, g):
    _, hi, lo = _split(rng, (tables, K, I))
    dp = hi.astype(np.float64) + lo.astype(np.float64)
    s = rng.integers(-1, 2, size=(tables * g, K)).astype(np.float64)
    s[:, ::5] = 0.0
    s[: g // 2, K // 3:] = 0.0              # whole tiles of σ = 0
    return dp, s


@pytest.mark.parametrize("tables,K,I,g", [
    (4, 512, 16, 64), (1, 1024, 16, 1024), (6, 1024, 16, 128),
    (1, 64, 8, 8), (12, 64, 8, 16), (3, 200, 24, 5), (2, 700, 12, 40),
    (8, 8, 16, 1024)])
def test_cols_walk_order_is_the_same_for_any_tables_and_g(rng, tables, K,
                                                          I, g):
    """A member's walk result depends on K and I alone: its plan among g
    members of a bucket of tables, alone on its table (the direct form),
    and other block shapes of either form give the same bits, within
    1e-12 of the exact product."""
    dp, s = _walk_case(rng, tables, K, I, g)
    plan = CK.cols_walk_plan(tables, K, I, g, 132)
    got = _walk_emulate(dp, s, g, plan)
    want = np.einsum("tgk,tki->tgi", s.reshape(tables, g, K), dp)
    assert _rel(got, want.reshape(-1, I)) <= EXACT_RTOL
    # the same members under other block shapes: one way and several, one
    # stage of K and stages of 1 or 3 tiles
    for alt in ((plan[0], 1, max(2, plan[2] // 2), 2, 3, 2, 1),
                (plan[0], 1, max(2, plan[2] // 2), 1, 1, 4, 1),
                (plan[0], 1, max(2, plan[2]), 4, -(-K // 64), 1, 1)):
        assert np.array_equal(_walk_emulate(dp, s, g, alt), got)
    # members alone on their table, with the plan the wrapper gives them,
    # and the direct form's other shapes (a round of one tile, clusters)
    for m in sorted({0, g - 1, (tables * g) // 2, tables * g - 1}):
        t = m // g
        for alone_plan in (CK.cols_walk_plan(1, K, I, 1, 132),
                           (1, 1, 1, 4, 1, 1, 1), (2, 1, 1, 8, 1, 1, 4)):
            alone = _walk_emulate(dp[t:t + 1], s[m:m + 1], 1, alone_plan)
            assert np.array_equal(alone[0], got[m])


@pytest.mark.parametrize("tables,K,I,g", [
    (1, 1024, 16, 64), (2, 700, 12, 40), (4, 512, 8, 16)])
def test_cols_walk_emulation_sees_another_order(rng, tables, K, I, g):
    """The emulation above can tell orders apart: stages of 96 rows, which
    cut tiles across stages, give other bits than the walk's 64-row tiles
    for some member (the same sum, so within 1e-12 of it)."""
    dp, s = _walk_case(rng, tables, K, I, g)
    plan = CK.cols_walk_plan(tables, K, I, g, 132)
    got = _walk_emulate(dp, s, g, plan)
    staged = (plan[0], 1, max(2, plan[2]), 4, 2, 2, 1)
    other = _walk_emulate(dp, s, g, staged, stage_rows=96)
    assert _rel(other, got) <= EXACT_RTOL
    assert not np.array_equal(other, got)
