"""Host threefry (longcallr_tpu_torch.phasing.rng) bit-equal to jax.random.

The perturbation schedule's random draws must carry the same bits in both
packages for their VCFs to be byte-equal. Tolerance: exact equality of
every uint32 key word and every float64 draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from longcallr_tpu.phasing import optimize as JO
from longcallr_tpu_torch.phasing import rng as R


def _seeds(n=60):
    g = np.random.default_rng(12345)
    s = g.integers(0, np.iinfo(np.int64).max, size=n, dtype=np.int64)
    return [0, 1, 2 ** 32 - 1, 2 ** 32, int(np.iinfo(np.int64).max)] + \
        [int(v) for v in s]


def test_prng_key_fold_in_split_bit_equal():
    """PRNGKey(int64) → fold_in(t) → split over >= 50 int64 seeds."""
    for seed in _seeds():
        k = jax.random.PRNGKey(seed)
        key = R.prng_key(seed)
        np.testing.assert_array_equal(np.asarray(k), key)
        for t in (0, 1, 77):
            kr = jax.random.fold_in(k, t)
            kr_np = R.fold_in(key, t)
            np.testing.assert_array_equal(np.asarray(kr), kr_np)
            k1, k2 = jax.random.split(kr)
            s = R.split(kr_np)
            np.testing.assert_array_equal(np.asarray(k1), s[0])
            np.testing.assert_array_equal(np.asarray(k2), s[1])


@pytest.mark.parametrize("n", [1, 8, 37, 512, 4096])
def test_uniform_f64_bit_equal(n):
    for seed in _seeds()[:50]:
        k = jax.random.PRNGKey(seed)
        u = jax.random.uniform(k, (n,))
        assert u.dtype == jnp.float64
        np.testing.assert_array_equal(np.asarray(u), R.uniform(R.prng_key(seed), n))


@pytest.mark.parametrize("K,I", [(8, 8), (64, 16), (512, 64), (4096, 512)])
def test_predraw_rounds_bit_equal(K, I):
    """The whole schedule's draws: [R_max, I] and [R_max, K] with
    R_max = I//4 + 1, as optimize._predraw_rounds makes them."""
    for seed in _seeds()[:3]:
        rg, fl = JO._predraw_rounds(jax.random.PRNGKey(seed), K, I)
        rg_np, fl_np = R.predraw_rounds(R.prng_key(seed), K, I)
        assert rg_np.shape == (I // 4 + 1, I) and fl_np.shape == (I // 4 + 1, K)
        np.testing.assert_array_equal(np.asarray(rg), rg_np)
        np.testing.assert_array_equal(np.asarray(fl), fl_np)
