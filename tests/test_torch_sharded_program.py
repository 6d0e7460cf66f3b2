"""The reads-sharded ascent as a group of programs, one per shard, on the CPU.

``parallel/mesh.sharded_ascent`` describes the ascent of one giant region
once per shard (``graphs.Group``): a prologue, a loop of trips and the
objective, the shards meeting at exchanges where the JAX package's
``shard_map`` program has its ``psum``s. The card runs one device program
per shard; the CPU walks the same description with the plain executor,
stage by stage, the exchanges as the plain sum in shard order
(``cuda_exchange.sum_in_order``), which is what runs here. The same seeded
numpy inputs (K = 512, I = 48) go through the JAX package's
``sharded_cross_optimize`` on its 8 virtual CPU devices and through the
port's on 1, 2, 4 and 8 CPU shards, for every (with_genotype,
keep_conserved).

Tolerances: σ, δ and η equal; the objective to 1e-9 relative, as the JAX
package holds its own sharded ascent (the column sums are products here, a
masked sum there: the same terms in another order). Between shard counts
of the port the states are equal; the exchange's plain form is bit-equal
to numpy's adds in shard order.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from longcallr_tpu.parallel import mesh as JM
from longcallr_tpu_torch.parallel import mesh as TM
from longcallr_tpu_torch.phasing import cuda_exchange as CX
from longcallr_tpu_torch.phasing import cuda_kernels as CK
from longcallr_tpu_torch.phasing import graphs

CPU = torch.device("cpu")
CASES = [(False, False), (False, True), (True, False), (True, True)]
K, I = 512, 48


@functools.lru_cache(maxsize=None)
def _args():
    """One giant-like region: reads on two haplotypes with 5 % noise, 60 %
    of the cells present, a few reads and SNPs masked out."""
    r = np.random.default_rng(20261017)
    hap = r.choice([-1, 1], size=I)
    side = r.choice([-1, 1], size=K)
    p = (side[:, None] * hap[None, :]).astype(np.int8)
    p = np.where(r.random((K, I)) < 0.05, -p, p)
    p = np.where(r.random((K, I)) < 0.6, p, 0).astype(np.int8)
    q = r.integers(3, 31, size=(K, I)).astype(np.uint8)
    rb = r.random(K) < 0.95
    sigma0 = np.where(rb, np.where(r.random(K) < 0.5, -1.0, 1.0), 0.0)
    delta0 = r.choice([-1.0, 1.0], size=I)
    eta0 = r.choice([-1.0, 0.0, 1.0], size=I, p=[0.1, 0.8, 0.1])
    sm = r.random(I) < 0.95
    cons = r.random(I) < 0.2
    return p, q, sigma0, delta0, eta0, rb, sm, cons


@functools.lru_cache(maxsize=None)
def _jax(with_genotype, keep_conserved):
    fn = JM.sharded_cross_optimize(JM.make_mesh(1, 8),
                                   with_genotype=with_genotype,
                                   keep_conserved=keep_conserved)
    return tuple(np.asarray(a) for a in fn(*(jnp.asarray(a)
                                             for a in _args())))


def _port(n, with_genotype, keep_conserved):
    return TM.sharded_cross_optimize([CPU] * n, with_genotype=with_genotype,
                                     keep_conserved=keep_conserved)(*_args())


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("with_genotype,keep_conserved", CASES)
def test_group_matches_jax_shard_map(n, with_genotype, keep_conserved):
    """The group walked by the plain executor on n CPU shards against the
    JAX shard_map program on 8 devices."""
    want = _jax(with_genotype, keep_conserved)
    got = _port(n, with_genotype, keep_conserved)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-9)
    assert got[0].shape == (K,) and got[3].shape == ()


@pytest.mark.parametrize("with_genotype,keep_conserved", CASES)
def test_two_and_eight_shards_reach_one_state(with_genotype, keep_conserved):
    two = _port(2, with_genotype, keep_conserved)
    eight = _port(8, with_genotype, keep_conserved)
    for a, b in zip(two[:3], eight[:3]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(two[3]), float(eight[3]), rtol=1e-12)


def _in_order(parts):
    """numpy's adds of the partials in shard order (not one pairwise sum)."""
    total = parts[0].numpy().copy()
    for p in parts[1:]:
        total = total + p.numpy()
    return torch.as_tensor(total)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_the_plain_exchange_is_sum_in_order(n):
    """The exchange's plain form against numpy's adds in shard order, bit
    for bit, on random f64 partials of mixed magnitudes and int64 counts;
    every shard of a group's CPU exchange holds the same bits."""
    r = np.random.default_rng(n)
    f = [torch.as_tensor(r.standard_normal(97) * 10.0 ** r.integers(
        -8, 9, 97)) for _ in range(n)]
    i = [torch.as_tensor(r.integers(-2**40, 2**40, 5)) for _ in range(n)]
    for parts in (f, i):
        got = CX.sum_in_order(parts, CPU)
        assert got.dtype == parts[0].dtype
        assert torch.equal(got, _in_order(parts))
    box = CX.ShardExchange([CPU] * n, 102)
    totals = [(torch.zeros(97, dtype=torch.float64),
               torch.zeros(5, dtype=torch.int64)) for _ in range(n)]
    nodes = [graphs.Exchange("x", box, s, (f[s], i[s]), totals[s])
             for s in range(n)]
    graphs.Group(box, [({}, (x,), ()) for x in nodes])._stage(nodes)
    for tf, ti in totals:
        assert torch.equal(tf, _in_order(f))
        assert torch.equal(ti, _in_order(i))


def _counting_group(n, turns_wanted):
    """A group of n CPU shards whose loop turns ``turns_wanted`` times: each
    shard adds 1 to its count, the counts are exchanged, and the loop goes
    on while the exchanged total is below n * turns_wanted. Every exchange
    is counted in ``seen``."""
    box = CX.ShardExchange([CPU] * n, 2)
    seen = [0] * n
    shards = []
    for s in range(n):
        total = torch.zeros(1, dtype=torch.int64)
        count = torch.zeros(1, dtype=torch.int64)
        more = torch.zeros((), dtype=torch.bool)

        def bump(s=s, count=count):
            count.add_(1)
            seen[s] += 1

        def decide(total=total, more=more):
            more.copy_(total[0] < n * turns_wanted)

        step = graphs.Piece("bump", bump)
        x = graphs.Exchange("count", box, s, (None, count), (None, total))
        done = graphs.Piece("decide", decide)
        shards.append(({}, (step, x, done,
                            graphs.While(more, (step, x, done))), (count,)))
    return graphs.Group(box, shards), seen


@pytest.mark.parametrize("n,turns", [(1, 1), (2, 3), (4, 5)])
def test_the_plain_executor_reads_a_flag_once_a_turn(n, turns):
    """The plain executor reads shard 0's flag once a loop turn (and once
    more to stop), counts each read, and every shard makes the exchanges
    that ``Group.turns`` expects of its body runs (the count the card's
    programs are held to)."""
    group, seen = _counting_group(n, turns)
    CK.reset_launches()
    try:
        runs = group.run_plain()
        reads = CK.GRAPHS["flag_reads"]
    finally:
        CK.reset_launches()
    assert runs == [turns - 1]
    assert reads == group.flag_reads == turns
    assert seen == [turns] * n
    assert all(group.turns(s, runs) == turns for s in range(n))
    assert all(int(out[0][0]) == turns for out in group.outputs)


def test_the_sharded_ascent_reads_one_flag_a_trip():
    """The ascent's first trip stands before its loop, so the plain
    executor reads the flag once a trip; on 2 and 8 shards alike."""
    reads = []
    for n in (2, 8):
        CK.reset_launches()
        try:
            _port(n, False, False)
            reads.append(CK.GRAPHS["flag_reads"])
            # the CPU's plain sums launch no exchange kernel
            assert CX.EXCHANGE_LAUNCHES == {"shard_exchange": 0}
        finally:
            CK.reset_launches()
    assert reads[0] == reads[1] >= 2


def test_a_group_over_two_kinds_of_device_raises():
    with pytest.raises(ValueError):
        CX.ShardExchange([CPU, torch.device("cuda", 0)], 4)
    with pytest.raises(ValueError):
        TM.sharded_cross_optimize([CPU, torch.device("cuda", 0)])(*_args())


def test_the_exchange_kernel_refuses_the_cpu():
    """On the CPU there is no shard-local exchange: the wrapper raises, and
    only the plain executor sums (no fallback)."""
    box = CX.ShardExchange([CPU] * 2, 4)
    part = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        CX.exchange(box, 0, part, None, part.clone(), None)


def test_the_coverage_counted_in_blocks_of_rows(monkeypatch):
    """The prologue counts the coverage COVER_ROWS rows at a time (a bool
    sum widens its operand to int64): blocks that cut the rows anywhere
    count what one sum over all rows counts, and the ascent reaches the
    same state and objective."""
    r = np.random.default_rng(7)
    m = torch.as_tensor(r.random((1000, 16)) < 0.6)
    rm0 = torch.as_tensor(r.random(1000) < 0.9)
    want = (m & rm0[:, None]).sum(0)
    whole = _port(2, False, True)
    for rows in (1, 37, 999, 1000, 8192):
        monkeypatch.setattr(TM, "COVER_ROWS", rows)
        out = torch.full((16,), -1, dtype=torch.int64)
        TM._coverage(m, rm0, out)
        assert torch.equal(out, want)
    monkeypatch.setattr(TM, "COVER_ROWS", 37)
    for a, b in zip(whole, _port(2, False, True)):
        assert torch.equal(a, b)


class _GroupLike:
    """Stands in for a ``graphs.Group`` in the program cache: its load
    takes the values alone, as a group's does."""

    def __init__(self):
        self.loads = 0

    def load(self, values):
        self.loads += 1

    def build(self):
        return {}

    def launch(self):
        return [torch.ones(1)], []

    def free(self):
        pass


def test_a_group_is_built_and_loaded_through_the_program_cache(monkeypatch):
    """A group (``device`` a list of shards) that runs as device programs
    is built once and loaded at every call by ``graphs.run``'s cache."""
    monkeypatch.setattr(graphs, "_device_program", lambda device, capture:
                        True)
    made = []

    def make():
        made.append(_GroupLike())
        return made[-1]

    try:
        for _ in range(2):
            out = graphs.run(("group_like",), [CPU, CPU], make,
                             {"x": torch.zeros(3)})
            assert torch.equal(out[0], torch.ones(1))
        assert len(made) == 1 and made[0].loads == 2
    finally:
        graphs.free_all()
