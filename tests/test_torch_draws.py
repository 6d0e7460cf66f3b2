"""The perturbation schedule's round draws (longcallr_tpu_torch.phasing.
cuda_draws) bit-equal to jax.random and to the host reference rng.py.

``round_draws`` on a CPU tensor runs its plain version, the one the CUDA
kernel of csrc/round_draws.cu is held against on the card. Its draws must
carry the bits of the JAX package's ``_predraw_rounds`` (vmapped over a
bucket's keys, as ``parallel/mesh.py`` draws them) and of
``rng.predraw_rounds`` for every key. Tolerance: exact equality of every
float64 draw, and of the schedule's states where the draws feed it; the
schedule's objectives within 1e-12 relative (the two packages sum in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcallr_tpu.parallel import mesh as JM
from longcallr_tpu.phasing import kernels as JK
from longcallr_tpu.phasing import optimize as JO
from longcallr_tpu_torch.parallel import mesh as TM
from longcallr_tpu_torch.phasing import cuda_draws as CD
from longcallr_tpu_torch.phasing import cuda_kernels as CK
from longcallr_tpu_torch.phasing import kernels as TK
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.phasing import rng as R
from longcallr_tpu_torch.utils.adopt import adopt_batch

SHAPES = [(8, 8), (64, 16), (2048, 256), (4096, 512)]
CPU = torch.device("cpu")
RTOL = 1e-12          # f64 objectives: summation order only


def _seeds(n=60):
    """The seeds of test_torch_rng.py: the edges of the int64 range, then
    random ones."""
    g = np.random.default_rng(12345)
    s = g.integers(0, np.iinfo(np.int64).max, size=n, dtype=np.int64)
    return [0, 1, 2 ** 32 - 1, 2 ** 32, int(np.iinfo(np.int64).max)] + \
        [int(v) for v in s]


def _groups(B):
    """Buckets of B seeds: every edge seed, and at least one bucket of
    random ones."""
    seeds = _seeds()
    return [seeds[j:j + B] for j in range(0, 5 + B, B)]


def _key_words(seeds):
    return CD.key_words([R.prng_key(s) for s in seeds], CPU)


def _jax_draws(seeds, K, I):
    """The JAX package's draws of a bucket: [R_max, B, I], [R_max, B, K]."""
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    rg, fl = jax.vmap(JO._predraw_rounds, in_axes=(0, None, None))(keys, K, I)
    return (np.asarray(rg).transpose(1, 0, 2),
            np.asarray(fl).transpose(1, 0, 2))


def _bits_equal(got: torch.Tensor, want: np.ndarray) -> None:
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.ascontiguousarray(want).view(np.uint64))


@pytest.mark.parametrize("B", [1, 2, 5])
@pytest.mark.parametrize("K,I", SHAPES)
def test_plain_draws_equal_jax_vmapped(K, I, B):
    R_max = I // 4 + 1
    for seeds in _groups(B):
        rg, fl = CD.round_draws(_key_words(seeds), R_max, I, K)
        want_rg, want_fl = _jax_draws(seeds, K, I)
        _bits_equal(rg, want_rg)
        _bits_equal(fl, want_fl)


@pytest.mark.parametrize("B", [1, 2, 5])
@pytest.mark.parametrize("K,I", SHAPES)
def test_plain_draws_equal_host_reference(K, I, B):
    R_max = I // 4 + 1
    for seeds in _groups(B):
        rg, fl = CD.round_draws_plain(_key_words(seeds), R_max, I, K)
        for b, s in enumerate(seeds):
            want_rg, want_fl = R.predraw_rounds(R.prng_key(s), K, I)
            _bits_equal(rg[:, b], want_rg)
            _bits_equal(fl[:, b], want_fl)


@pytest.mark.parametrize("n_rounds", [0, 1, 7, 64])
def test_fewer_rounds_are_the_first_rounds(n_rounds):
    """R < R_max rounds are the first R of the JAX package's R_max."""
    K, I = 2048, 256
    seeds = _seeds()[3:6]
    rg, fl = CD.round_draws(_key_words(seeds), n_rounds, I, K)
    want_rg, want_fl = _jax_draws(seeds, K, I)
    assert n_rounds < I // 4 + 1
    _bits_equal(rg, want_rg[:n_rounds])
    _bits_equal(fl, want_fl[:n_rounds])


def test_one_region_form():
    """keys [2] → [R, I], [R, K]: the bucket's form without its B axis."""
    words = _key_words([2 ** 32])
    rg, fl = CD.round_draws(words[0], 9, 32, 100)
    rg_b, fl_b = CD.round_draws(words, 9, 32, 100)
    assert rg.shape == (9, 32) and fl.shape == (9, 100)
    assert torch.equal(rg, rg_b[:, 0]) and torch.equal(fl, fl_b[:, 0])
    want_rg, want_fl = R.predraw_rounds(R.prng_key(2 ** 32), 100, 32)
    _bits_equal(rg, want_rg)
    _bits_equal(fl, want_fl)


def test_65536_keys_in_one_call():
    """65,536 keys with 2 rounds: more keys than the third dimension of a
    grid holds, which the kernel folds into launches of 65,535; the plain
    version it is held against on the card computes every key as alone,
    and writes into given buffers as it returns new ones."""
    g = np.random.default_rng(4)
    seeds = [int(v) for v in g.integers(0, np.iinfo(np.int64).max,
                                        size=65536, dtype=np.int64)]
    words = _key_words(seeds)
    rg, fl = CD.round_draws(words, 2, 8, 16)
    assert rg.shape == (2, 65536, 8) and fl.shape == (2, 65536, 16)
    for b in (0, 65534, 65535):
        one_rg, one_fl = CD.round_draws(words[b], 2, 8, 16)
        assert torch.equal(rg[:, b], one_rg) and torch.equal(fl[:, b], one_fl)
    want_rg, want_fl = R.predraw_rounds(R.prng_key(seeds[65535]), 16, 8)
    _bits_equal(rg[:, 65535], want_rg[:2])
    _bits_equal(fl[:, 65535], want_fl[:2])
    out = (torch.empty_like(rg), torch.empty_like(fl))
    got = CD.round_draws(words, 2, 8, 16, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(out[0], rg) and torch.equal(out[1], fl)
    with pytest.raises(ValueError, match="out must be"):
        CD.round_draws(words, 2, 8, 16, out=(rg[:1], fl))


def test_cpu_call_counts_no_launch():
    CK.reset_launches()
    CK.set_launch_row(2)
    try:
        CD.round_draws(_key_words([1, 2]), 5, 16, 64)
    finally:
        CK.set_launch_row(None)
    assert CD.DRAW_LAUNCHES == {"round_draws": 0}
    assert CD.DRAW_LAUNCHES_BY_ROW == {}


def test_wrapper_refuses_what_the_kernel_does_not_take():
    words = _key_words([1, 2])
    with pytest.raises(TypeError, match="int64"):
        CD.round_draws(words.to(torch.int32), 3, 8, 8)
    with pytest.raises(ValueError, match=r"\[B, 2\]"):
        CD.round_draws(words.reshape(4), 3, 8, 8)
    with pytest.raises(ValueError, match="negative"):
        CD.round_draws(words, -1, 8, 8)


def _bucket(seed, B, K, I):
    """A planted bucket (numpy): reads on one of two haplotypes, 5 % cell
    noise, and a first state."""
    r = np.random.default_rng(seed)
    hap = r.choice([-1, 1], size=(B, K))
    td = r.choice([-1.0, 1.0], size=(B, I))
    p = (hap[:, :, None] * td[:, None, :]).astype(np.int8)
    p = np.where(r.random((B, K, I)) < 0.05, -p, p)
    p = np.where(r.random((B, K, I)) < 0.6, p, 0).astype(np.int8)
    rb = r.random((B, K)) < 0.95
    batch = JM.BatchedRegions(
        p=jnp.asarray(p),
        q=jnp.asarray(r.integers(3, 31, size=(B, K, I)).astype(np.uint8)),
        read_base=jnp.asarray(rb),
        site_mask=jnp.asarray(r.random((B, I)) < 0.95),
        conserved=jnp.asarray(r.random((B, I)) < 0.15))
    state = (np.where(rb, r.choice([-1.0, 1.0], size=(B, K)), 0.0),
             r.choice([-1.0, 1.0], size=(B, I)), np.zeros((B, I)))
    return batch, state


def test_bucket_of_mixed_round_counts_below_r_max_matches_jax():
    """A bucket whose members run 2, 5 and 3 rounds of the R_max = 9 that
    I = 32 draws: both packages draw all 9 and the loop reads the first 5;
    the states are the same."""
    B, K, I = 3, 96, 32
    jbatch, state = _bucket(31, B, K, I)
    sg, dl, et, pr = (np.asarray(a) for a in JM.batched_cross_optimize(
        jbatch, *map(jnp.asarray, state)))
    n_rounds = np.array([2, 5, 3])
    assert n_rounds.max() < I // 4 + 1
    seeds = _seeds()[10:10 + B]
    want = JM.batched_perturbation_phase(
        jbatch, jnp.asarray(sg), jnp.asarray(dl), jnp.asarray(et),
        jnp.asarray(pr), jnp.asarray(n_rounds.astype(np.int32)),
        jnp.stack([jax.random.PRNGKey(s) for s in seeds]))
    t = lambda a: torch.as_tensor(np.array(a))
    got = TM.batched_perturbation_phase(
        adopt_batch(jbatch, CPU), t(sg), t(dl), t(et), t(pr), n_rounds,
        [R.prng_key(s) for s in seeds])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=RTOL)
    # the members' own schedules moved them: the draws were used
    assert any(not np.array_equal(g.numpy(), a)
               for g, a in zip(got[:3], (sg, dl, et)))


def test_one_region_schedule_of_fewer_rounds_matches_jax():
    """perturbation_phase of one region with 3 of its R_max = 7 rounds:
    both packages draw 7 and read 3; the best states are the same."""
    r = np.random.default_rng(41)
    K, I, n_rounds = 96, 24, 3
    p = r.choice([-1, 0, 1], size=(K, I), p=[0.3, 0.4, 0.3]).astype(np.int8)
    q = r.integers(10, 31, size=(K, I)).astype(np.uint8)
    rb = r.random(K) < 0.9
    sig0 = np.where(rb, r.choice([-1.0, 1.0], K), 0.0)
    dl0 = r.choice([-1.0, 1.0], I)
    sm, cons = np.ones(I, bool), np.zeros(I, bool)
    jct = JK.make_cell_tables(p, q)
    jst0 = JO.PhaseState(jnp.asarray(sig0), jnp.asarray(dl0), jnp.zeros(I))
    jst1, jprob = JO.selected_loop()(jct, jst0, jnp.asarray(rb),
                                     jnp.asarray(sm), jnp.asarray(cons),
                                     False, False)
    seed = _seeds()[20]
    jb, jp = JO.perturbation_phase(jct, jst1, jst1, jprob, jnp.asarray(rb),
                                   jnp.asarray(sm), jnp.asarray(cons),
                                   jnp.int32(n_rounds),
                                   jax.random.PRNGKey(seed))
    t = lambda a: torch.as_tensor(np.array(a))
    tst1 = TO.PhaseState.from_numpy(*(np.asarray(a) for a in jst1))
    tb, tp = TO.perturbation_phase(TK.CompactCells.from_numpy(p, q), tst1,
                                   tst1, float(jprob), t(rb), t(sm), t(cons),
                                   n_rounds, R.prng_key(seed))
    for g, w in zip(tb, jb):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(float(tp), float(jp), rtol=RTOL)


def test_rounds_past_the_draws_are_refused():
    """More rounds than the I // 4 + 1 that the JAX package draws are no
    longer refused: a round past them reads the last drawn round's draws
    again, as the JAX package's clamped dynamic index does, for one region
    and for a bucket (the states equal the JAX package's)."""
    B, K, I = 1, 16, 8
    jbatch, state = _bucket(5, B, K, I)
    tb = adopt_batch(jbatch, CPU)
    sg, dl, et = (torch.as_tensor(a) for a in state)
    n = I // 4 + 2
    seed = _seeds()[7]
    got = TM.batched_perturbation_phase(
        tb, sg, dl, et, torch.zeros(1, dtype=torch.float64), np.array([n]),
        [R.prng_key(seed)])
    want = JM.batched_perturbation_phase(
        jbatch, *map(jnp.asarray, state), jnp.zeros(1),
        jnp.asarray(np.array([n], np.int32)),
        jnp.stack([jax.random.PRNGKey(seed)]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    st = TO.PhaseState(sg[0], dl[0], et[0])
    jst = JO.PhaseState(*(jnp.asarray(a[0]) for a in state))
    tb1, _ = TO.perturbation_phase(TK.CompactCells(tb.p[0], tb.q[0]), st,
                                   st, 0.0, tb.read_base[0],
                                   tb.site_mask[0], tb.conserved[0], n,
                                   R.prng_key(seed))
    jb1, _ = JO.perturbation_phase(
        JK.make_cell_tables(np.asarray(jbatch.p[0]), np.asarray(jbatch.q[0])),
        jst, jst, 0.0, jbatch.read_base[0], jbatch.site_mask[0],
        jbatch.conserved[0], jnp.int32(n), jax.random.PRNGKey(seed))
    for g, w in zip(tb1, jb1):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
