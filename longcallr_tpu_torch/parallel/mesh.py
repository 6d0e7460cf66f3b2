"""Bucket programs of the phasing engine: a batch of same-shape regions
through the same launches (torch), and the programs that spread work over
several devices.

Port of ``longcallr_tpu/parallel/mesh.py``.
There a program is a jitted ``vmap`` over the regions of a bucket, sharded
over a device mesh; here it is a plain function whose tensors carry the
region axis first and run on the device they lie on: every elementwise
step and both hand-kernel matvecs (``cuda_kernels``, one table per member)
take the whole bucket in one launch, and an ascent is the masked loop of
``optimize._ascent`` — each member freezes when its own continue flag
drops, the loop ends when the last one has. The ascents, the fused phase
(``batched_phase_fused``) and the perturbation schedule are device programs
on the card (``phasing/graphs.py``), built once per shape: their loops run
on the device. A member's result never depends on its bucket-mates:
its tables, its random draws (``keys``, one threefry key per region) and
its round count are its own.

``split`` selects the mode as everywhere in the port: the f32-split tables
through the hand kernels (on for CUDA tensors) or f64 (on the CPU);
``None`` resolves it from the bucket's device (``optimize.split_mode``).

A mesh here is an explicit grid of ``torch.device``s of one type
(``make_mesh``), not a ``jax.sharding.Mesh``; a plain list of devices serves
as the "reads" axis.

Along "regions" every bucket program takes ``mesh=``: the bucket is cut at
``np.linspace(0, B, rows + 1)`` into one contiguous share per row of the
grid (``shard_regions``; a row with no regions is skipped), each share runs
on the first device of its row, and the rows run at the same time, one
host thread each (``_run_rows``), where the JAX package shards the vmapped
program over the devices. A row's launches stay ordered on its device's
current stream, so rows that repeat one card serialise their device work
there and overlap their host work. The results come back in region order
on the device of the state arguments. A cut never changes a member's
result (see above); only the loop of the perturbation schedule is the
bucket's, as in the JAX program: every row runs to the largest round count
of the whole bucket.

Along "reads" (``read_sharded_snp_sums``, ``sharded_cross_optimize``: one
giant region) the rows of ``[K,I]`` are cut into one contiguous shard per
device; the per-read half-step stays on its shard and the per-SNP partial
sums are added in shard order in f64, where the JAX package reduces with
``psum``: the result does not depend on timing. The ascent is a group of
device programs, one per shard, that meet at exchanges (``sharded_ascent``).
"""

from __future__ import annotations

import contextlib
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..phasing import cuda_exchange as CX
from ..phasing import cuda_kernels as CK
from ..phasing import graphs
from ..phasing import kernels_fast as KF
from ..phasing import optimize as O
from ..phasing.kernels import (TIE_TOL, CompactCells, expand_cells, f64,
                               overall_probability, read_logliks, sigma_q,
                               snp_qs, snp_sums)
from ..phasing.optimize import PhaseState


class BatchedRegions(NamedTuple):
    """A bucket of B same-shape padded regions, in compact transfer form
    (2 bytes/cell; the emission tables expand on the device inside each
    program)."""

    p: torch.Tensor          # [B,K,I] int8 in {-1,0,+1}
    q: torch.Tensor          # [B,K,I] uint8 capped baseq
    read_base: torch.Tensor  # [B,K] bool
    site_mask: torch.Tensor  # [B,I] bool
    conserved: torch.Tensor  # [B,I] bool

    @classmethod
    def from_numpy(cls, p, q, read_base, site_mask, conserved,
                   device: torch.device) -> "BatchedRegions":
        on = lambda a, dt: torch.as_tensor(np.array(a, dt), device=device)
        return cls(on(p, np.int8), on(q, np.uint8), on(read_base, bool),
                   on(site_mask, bool), on(conserved, bool))

    @property
    def cells(self) -> CompactCells:
        return CompactCells(self.p, self.q)


class Mesh(NamedTuple):
    """A 2-D grid of devices: ``devices[r][c]`` is the device of row r of
    the "regions" axis and column c of the "reads" axis."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, str] = ("regions", "reads")

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])


def make_mesh(n_regions_axis: Optional[int] = None,
              n_reads_axis: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The devices (default: every CUDA device of this process) as a
    (regions, reads) grid; a missing axis size takes what is left."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if n_regions_axis is None:
        n_reads_axis = n_reads_axis or 1
        n_regions_axis = n // n_reads_axis
    if n_reads_axis is None:
        n_reads_axis = n // n_regions_axis
    if n_regions_axis * n_reads_axis != n or n == 0:
        raise ValueError(f"a ({n_regions_axis}, {n_reads_axis}) mesh needs "
                         f"{n_regions_axis * n_reads_axis} devices, got {n}")
    mesh = Mesh(tuple(tuple(devices[r * n_reads_axis:(r + 1) * n_reads_axis])
                      for r in range(n_regions_axis)))
    mesh_device(mesh)
    return mesh


def mesh_device(mesh: Mesh) -> torch.device:
    """The first device of the grid. Raises ValueError where the grid mixes
    device types (a CPU and a card): a mesh runs one kind of program."""
    kinds = sorted({d.type for row in mesh.devices for d in row})
    if len(kinds) != 1:
        raise ValueError(f"a mesh holds devices of one type, got {kinds}")
    return mesh.devices[0][0]


class RegionRows(NamedTuple):
    """A bucket cut along the "regions" axis of a mesh (``shard_regions``):
    for each row of the grid that holds regions, its index in the grid,
    its first device, its bounds [b0, b1) in the bucket and its share,
    which lies on that device."""

    rows: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    bounds: Tuple[Tuple[int, int], ...]
    batches: Tuple[BatchedRegions, ...]


def shard_regions(batch: BatchedRegions, mesh: Mesh) -> RegionRows:
    """Cut a bucket (tensors on any device, or host numpy arrays) into the
    shares of the mesh's rows, each sent to the first device of its row.
    The bucket programs take the result in place of a batch, so a bucket
    that goes through several programs is cut and sent once."""
    mesh_device(mesh)
    B = batch.p.shape[0]
    cut = np.linspace(0, B, mesh.shape[0] + 1).astype(int)
    rows, devices, bounds, batches = [], [], [], []
    for r, (b0, b1) in enumerate(zip(cut[:-1].tolist(), cut[1:].tolist())):
        if b1 == b0:
            continue
        dev = mesh.devices[r][0]
        rows.append(r)
        devices.append(dev)
        bounds.append((b0, b1))
        batches.append(BatchedRegions(*(torch.as_tensor(a[b0:b1]).to(dev)
                                        for a in batch)))
    return RegionRows(tuple(rows), tuple(devices), tuple(bounds),
                      tuple(batches))


def _row_args(args, b0: int, b1: int, dev: torch.device, per_region: bool):
    """A row's arguments: per-region ones cut to [b0, b1) (tensors, round
    counts, lists of keys), shared ones whole; tensors sent to ``dev``."""
    out = []
    for a in args:
        if per_region:
            a = a[b0:b1]
        out.append(a.to(dev) if isinstance(a, torch.Tensor) else a)
    return out


def _run_rows(rows: RegionRows, fn, per_region=(), shared=(),
              home: Optional[torch.device] = None) -> list:
    """``fn(i, share, *per-region args, *shared args)`` for every row i of
    ``rows``, each row in a host thread of its own (the only row in the
    calling thread), on the stream that is current on its device in the
    calling thread; the launches of each thread are counted for its row
    (``cuda_kernels.LAUNCHES_BY_ROW``). ``fn`` returns a tuple; its tensors
    are sent to ``home`` inside the row's thread. Returns the rows'
    tuples in row order."""
    streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
               for d in rows.devices]

    def one(i: int):
        dev = rows.devices[i]
        b0, b1 = rows.bounds[i]
        args = (_row_args(per_region, b0, b1, dev, True)
                + _row_args(shared, b0, b1, dev, False))
        on_stream = (torch.cuda.stream(streams[i]) if streams[i] is not None
                     else contextlib.nullcontext())
        CK.set_launch_row(rows.rows[i])
        try:
            with on_stream:
                out = fn(i, rows.batches[i], *args)
                return tuple(o.to(home) if isinstance(o, torch.Tensor)
                             and home is not None else o for o in out)
        finally:
            CK.set_launch_row(None)

    n = len(rows.batches)
    if n == 1:
        return [one(0)]
    with ThreadPoolExecutor(max_workers=n) as ex:
        futures = [ex.submit(one, i) for i in range(n)]
        return [f.result() for f in futures]


def _rows_of(batch, mesh: Mesh) -> RegionRows:
    """A bucket's rows: those it was cut into already, or its cut here."""
    if isinstance(batch, RegionRows):
        return batch
    return shard_regions(batch, mesh)


def _on_mesh(mesh: Mesh, batch, fn, per_region, shared=()) -> tuple:
    """Run ``fn`` (see ``_run_rows``) over the rows of ``batch`` (a bucket,
    cut here, or the RegionRows of one) and join its outputs along
    regions, on the device of the first per-region argument."""
    parts = _run_rows(_rows_of(batch, mesh), fn, per_region, shared,
                      per_region[0].device)
    return tuple(torch.cat([p[k] for p in parts]) for k in range(len(parts[0])))


def _split(batch, split: Optional[bool]) -> bool:
    """The mode of a program: ``split`` or, where None, the one of the
    bucket's device (of its rows' devices, for a cut bucket)."""
    if split is not None:
        return bool(split)
    if isinstance(batch, RegionRows):
        return O.split_mode(batch.devices[0])
    return O.split_mode(batch.p.device)


def _tables(batch: BatchedRegions, sigma, split: bool):
    return O._fast_tables_for(batch.cells, batch.read_base, sigma,
                              batch.site_mask, split)


def batched_cross_optimize(batch: BatchedRegions, sigma, delta, eta,
                           keep_conserved: bool = True,
                           with_genotype: bool = False,
                           split: Optional[bool] = None,
                           mesh: Optional[Mesh] = None):
    """Full ≤21-iteration coordinate ascent over a region bucket.
    Returns (sigma, delta, eta, prob[B])."""
    if mesh is not None:
        return _on_mesh(mesh, batch, lambda i, b, sg, dl, et:
                        batched_cross_optimize(b, sg, dl, et, keep_conserved,
                                               with_genotype, split),
                        (sigma, delta, eta))
    st, prob = O.cross_optimize(
        batch.cells, PhaseState(sigma, delta, eta), batch.read_base,
        batch.site_mask, batch.conserved, with_genotype, keep_conserved,
        _split(batch, split))
    return st.sigma, st.delta, st.eta, prob


def _one_sweep(batch: BatchedRegions, sigma, delta, eta, with_genotype: bool,
               keep_conserved: bool):
    """One σ half-step then one (δ, η) half-step of the reference form on
    every region of ``batch`` (phase.rs:823-965)."""
    ct = expand_cells(batch.cells)
    lp, lm, ncell = read_logliks(ct, delta, eta, batch.site_mask)
    upd = batch.read_base & (sigma != 0) & (ncell > 0)
    q, qn = sigma_q(lp, lm, sigma)
    flip = upd & (qn > q + TIE_TOL)
    new_sigma = torch.where(flip, -sigma, sigma)
    st = PhaseState(new_sigma, delta, eta)
    sums = snp_sums(ct, new_sigma, delta, batch.read_base & (new_sigma != 0),
                    batch.site_mask)
    new_delta, new_eta, changed = O._snp_decision(
        *snp_qs(*sums), sums[4], st, batch.site_mask, batch.conserved,
        with_genotype, keep_conserved)
    return new_sigma, new_delta, new_eta, flip.any(dim=-1) | changed


def batched_phase_step(batch: BatchedRegions, sigma, delta, eta,
                       with_genotype: bool = False,
                       keep_conserved: bool = False,
                       mesh: Optional[Mesh] = None):
    """One full coordinate-ascent sweep over a bucket of regions. Returns
    (sigma, delta, eta, improved[B]).

    With a mesh, the bucket is cut along "regions" into one contiguous share
    per row of the grid; the rows run at the same time, each on the first
    device of its row (pure data parallelism, nothing is exchanged), and
    the results come back in order to the device of ``sigma``."""
    if mesh is not None:
        return _on_mesh(mesh, batch, lambda i, b, sg, dl, et: _one_sweep(
            b, sg, dl, et, with_genotype, keep_conserved), (sigma, delta, eta))
    return _one_sweep(batch, sigma, delta, eta, with_genotype,
                      keep_conserved)


def _devices(mesh) -> List[torch.device]:
    """The devices of the "reads" axis: a plain list, or the first row of a
    Mesh."""
    if isinstance(mesh, Mesh):
        return list(mesh.devices[0])
    return [torch.device(d) for d in mesh]


def _row_bounds(K: int, n: int) -> np.ndarray:
    """Row offsets of ``n`` contiguous shards of ``K`` rows."""
    if K < n:
        raise ValueError(f"{K} rows cannot fill {n} shards")
    return np.linspace(0, K, n + 1).astype(int)


def read_sharded_snp_sums(mesh):
    """Per-SNP masked sums for ONE giant region with its reads cut into one
    contiguous shard per device of ``mesh`` (a list of devices, or a Mesh's
    "reads" axis). Returns fn(p, lerr, l1m, sigma, read_mask, site_mask,
    delta) → (s_match, s_flip, s_refe, s_alte, cov), each [I] on the first
    device, the partial sums added in shard order (f64; cov int64)."""
    devs = _devices(mesh)

    def fn(p, lerr, l1m, sigma, read_mask, site_mask, delta):
        t = lambda a: torch.as_tensor(a)
        p, lerr, l1m, sigma, read_mask = map(t, (p, lerr, l1m, sigma,
                                                 read_mask))
        bounds = _row_bounds(p.shape[0], len(devs))
        parts = []
        for d, r0, r1 in zip(devs, bounds[:-1], bounds[1:]):
            sm, dl = t(site_mask).to(d), t(delta).to(d, f64)
            pp = p[r0:r1].to(d, f64)
            m = sm[None, :] & (pp != 0) & read_mask[r0:r1].to(d)[:, None]
            x = sigma[r0:r1].to(d, f64)[:, None] * dl[None, :]
            le, l1 = lerr[r0:r1].to(d, f64), l1m[r0:r1].to(d, f64)
            term = lambda xv: torch.where(pp == xv, l1, le)
            zero = torch.zeros((), dtype=f64, device=d)
            parts.append((torch.where(m, term(x), zero).sum(0),
                          torch.where(m, term(-x), zero).sum(0),
                          torch.where(m, term(1.0), zero).sum(0),
                          torch.where(m, term(-1.0), zero).sum(0),
                          m.sum(0, dtype=torch.int64)))
        return tuple(CX.sum_in_order([pt[k] for pt in parts], devs[0])
                     for k in range(5))

    return fn


class ReadShards(NamedTuple):
    """One region's σ-independent tables, cut into contiguous row shards,
    each on its device (built once per region, ``shard_cells``). ``key``
    tells the region's shards apart in the program cache: the ascent's
    programs read these tables where they lie (``sharded_ascent``)."""

    devices: List[torch.device]
    bounds: np.ndarray          # row offsets of the shards, [n + 1]
    lerr_m: List[torch.Tensor]  # [K_s,I] f64 log10(err) on phase-site cells
    diff: List[torch.Tensor]    # [K_s,I] f64 l1m - lerr on phase-site cells
    dp: List[torch.Tensor]      # [K_s,I] f64 diff * p
    m: List[torch.Tensor]       # [K_s,I] bool phase-site cells
    row_b: List[torch.Tensor]   # [K_s] Σ lerr over phase-site cells
    row_dif: List[torch.Tensor]  # [K_s] Σ diff
    row_cells: List[torch.Tensor]  # [K_s] phase-site cells of the read
    read_base: List[torch.Tensor]  # [K_s] bool
    key: int = 0


_SHARD_KEYS = itertools.count(1)
# rows of a shard whose coverage the ascent's prologue counts at a time
COVER_ROWS = 8192


def shard_cells(devices, p8, q8, read_base, site_mask) -> ReadShards:
    """Cut a region's compact cells (int8 allele, uint8 baseq: 2 bytes a
    cell travel) into one row shard per device and expand each shard's rows
    on its own device (kernels.expand_cells)."""
    devs = _devices(devices)
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"the reads axis mixes device kinds: {devs}")
    t = lambda a: torch.as_tensor(a)
    p8, q8, read_base, site_mask = map(t, (p8, q8, read_base, site_mask))
    bounds = _row_bounds(p8.shape[0], len(devs))
    cols = {k: [] for k in ReadShards._fields[2:-1]}
    for d, r0, r1 in zip(devs, bounds[:-1], bounds[1:]):
        ct = expand_cells(CompactCells(p8[r0:r1].to(d), q8[r0:r1].to(d)))
        zero = torch.zeros((), dtype=f64, device=d)
        m = site_mask.to(d)[None, :] & ct.exists
        diff = torch.where(m, ct.l1m - ct.lerr, zero)
        lerr_m = torch.where(m, ct.lerr, zero)
        for k, v in (("lerr_m", lerr_m), ("diff", diff),
                     ("dp", diff * ct.p), ("m", m), ("row_b", lerr_m.sum(1)),
                     ("row_dif", diff.sum(1)), ("row_cells", m.sum(1)),
                     ("read_base", read_base[r0:r1].to(d))):
            cols[k].append(v)
    return ReadShards(devs, bounds, **cols, key=next(_SHARD_KEYS))


@contextlib.contextmanager
def held_shards(devices, p8, q8, read_base, site_mask):
    """``shard_cells`` for the length of a ``with`` block: the ascent
    programs cached for these shards (they read the shards' tables where
    they lie) are freed at its end."""
    sh = shard_cells(devices, p8, q8, read_base, site_mask)
    try:
        yield sh
    finally:
        graphs.free_where(lambda k: k[0] == "sharded" and k[3] == sh.key)


def _coverage(m, rm0, out) -> None:
    """``out`` = Σ over the rows of ``m & rm0[:, None]``, COVER_ROWS rows
    at a time: a bool sum widens its operand to int64, 8 bytes a cell,
    which a captured piece's pool would keep."""
    out.zero_()
    for r in range(0, m.shape[0], COVER_ROWS):
        out.add_((m[r:r + COVER_ROWS] & rm0[r:r + COVER_ROWS, None]).sum(0))


def _shard_program(sh: ReadShards, s: int, box, values: dict,
                   with_genotype: bool, keep_conserved: bool):
    """Shard ``s``'s part of the ascent group: (inputs, nodes, outputs).
    The prologue sets up the active reads and the column partials (as
    products with the active-read vector, and the coverage in blocks of
    COVER_ROWS rows: no [K_s, I] temporary), a trip is the σ half-step on
    the shard's rows, the exchange of the flip count and dpᵀσ, and the
    (δ, η) half-step on the exchanged sums, replicated on every shard; the
    objective's partial is exchanged last."""
    d = sh.devices[s]
    I = sh.dp[s].shape[1]
    z, inputs = O._input_buffers(values, d)
    K_s = z.sigma.shape[0]
    zeros = lambda *shape, dtype=f64: torch.zeros(shape, dtype=dtype,
                                                  device=d)
    z.rm0, z.upd = zeros(K_s, dtype=torch.bool), zeros(K_s, dtype=torch.bool)
    z.rm0f, z.sg = zeros(K_s), zeros(K_s)
    z.dl, z.et, z.dts, z.trip_f = zeros(I), zeros(I), zeros(I), zeros(I)
    z.cols_f, z.col_f = zeros(3 * I), zeros(3 * I)
    z.cols_i, z.cov = zeros(I, dtype=torch.int64), zeros(I, dtype=torch.int64)
    z.trip_i, z.nflips = (zeros(1, dtype=torch.int64),
                          zeros(1, dtype=torch.int64))
    z.obj_f, z.prob = zeros(1), zeros(1)
    z.count = zeros(dtype=torch.int64)
    z.more = zeros(dtype=torch.bool)
    dp = sh.dp[s]

    def prologue():
        rm0 = sh.read_base[s] & (z.sigma != 0)
        z.rm0.copy_(rm0)
        z.rm0f.copy_(rm0.to(f64))
        z.upd.copy_(rm0 & (sh.row_cells[s] > 0))
        for k, tab in enumerate((sh.lerr_m[s], sh.diff[s], dp)):
            z.cols_f[k * I:(k + 1) * I].copy_(tab.T @ z.rm0f)
        _coverage(sh.m[s], rm0, z.cols_i)
        z.sg.copy_(z.sigma)
        z.dl.copy_(z.delta)
        z.et.copy_(z.eta)
        z.count.zero_()

    def uv():
        return (torch.where(z.et == 0, z.dl, 0.0),
                torch.where(z.et == 0, 0.0, z.et))

    def sigma_step():
        u, v = uv()
        du = dp @ u
        dv = dp @ v
        base = sh.row_b[s] + 0.5 * sh.row_dif[s] + 0.5 * dv
        q, qn = sigma_q(base + 0.5 * du, base - 0.5 * du, z.sg)
        flip = z.upd & (qn > q + TIE_TOL)
        z.sg.copy_(torch.where(flip, -z.sg, z.sg))
        z.trip_i.copy_(flip.sum().reshape(1))
        z.trip_f.copy_(dp.T @ torch.where(z.rm0, z.sg, 0.0))

    def snp_step():
        col_b, col_dif, col_dp = z.col_f[:I], z.col_f[I:2 * I], z.col_f[2 * I:]
        base = col_b + 0.5 * col_dif
        half = 0.5 * z.dl * z.dts
        sums = (base + half, base - half, base + 0.5 * col_dp,
                base - 0.5 * col_dp, z.cov)
        new_delta, new_eta, d_inc = O._snp_decision(
            *snp_qs(*sums), z.cov, PhaseState(z.sg, z.dl, z.et), z.site_mask,
            z.conserved, with_genotype, keep_conserved)
        z.dl.copy_(new_delta)
        z.et.copy_(new_eta)
        z.count.add_(1)
        z.more.copy_(((z.nflips[0] > 0) | d_inc) & (z.count < O.MAX_TRIPS))

    def objective():
        # the objective in matvec form, this shard's reads
        u, v = uv()
        per = torch.where(z.rm0, sh.row_b[s] + 0.5 * sh.row_dif[s]
                          + 0.5 * (z.sg * (dp @ u) + dp @ v), 0.0).sum()
        z.obj_f.copy_(per.reshape(1))

    X = lambda name, parts, totals: graphs.Exchange(name, box, s, parts,
                                                    totals)
    sigma = graphs.Piece("sigma", sigma_step)
    trip = X("trip", (z.trip_f, z.trip_i), (z.dts, z.nflips))
    snp = graphs.Piece("snp", snp_step)
    nodes = (graphs.Piece("prologue", prologue),
             X("columns", (z.cols_f, z.cols_i), (z.col_f, z.cov)),
             sigma, trip, snp,
             graphs.While(z.more, (sigma, trip, snp)),
             graphs.Piece("objective", objective),
             X("objective", (z.obj_f, None), (z.prob, None)))
    return inputs, nodes, (z.sg, z.dl, z.et, z.prob)


def sharded_ascent(sh: ReadShards, sigma0, delta0, eta0, site_mask,
                   conserved, with_genotype: bool, keep_conserved: bool):
    """Full ≤21-trip coordinate ascent of one region over its row shards,
    the counterpart of the JAX package's shard_map program: a
    ``graphs.Group`` of one program per shard (``_shard_program``), whose
    shards meet at exchanges (the psums: the column sums, the flip count
    with dpᵀσ each trip, the objective) that sum the partials in shard
    order on every shard (``cuda_exchange``), so every shard makes the same
    (δ, η) decisions and its loop turns as often. On the card each shard's
    trips run in a WHILE node of its program and no loop flag is read on
    the host; the shards' tables are read where they lie (the program is
    kept per region and (with_genotype, keep_conserved) until the
    ``held_shards`` block ends). Returns (sigma [K], delta, eta, prob) on
    the first device."""
    devs = sh.devices
    home = devs[0]
    I = sh.dp[0].shape[1]
    t = lambda a, dt: torch.as_tensor(a).to(dtype=dt)
    values = dict(sigma=t(sigma0, f64), delta=t(delta0, f64),
                  eta=t(eta0, f64), site_mask=t(site_mask, torch.bool),
                  conserved=t(conserved, torch.bool))

    def make():
        box = CX.ShardExchange(devs, 4 * I)
        shards = []
        for s, (r0, r1) in enumerate(zip(sh.bounds[:-1], sh.bounds[1:])):
            mine = {k: (v[r0:r1] if k == "sigma" else v)
                    for k, v in values.items()}
            shards.append(_shard_program(sh, s, box, mine, with_genotype,
                                         keep_conserved))
        return graphs.Group(box, shards, rows=("sigma",), bounds=sh.bounds)

    kind = ("sharded", with_genotype, keep_conserved, sh.key)
    outs = graphs.run(kind, list(devs), make, values)
    sigma = torch.cat([o[0].to(home) for o in outs])
    delta, eta, prob = outs[0][1:]
    return sigma, delta, eta, prob.reshape(())


def sharded_cross_optimize(mesh, with_genotype: bool = False,
                           keep_conserved: bool = False):
    """Full coordinate ascent for ONE giant region with its reads sharded
    over the devices of ``mesh`` (a list of devices, or a Mesh's "reads"
    axis): the sequence-parallel analog of the JAX package's shard_map
    program (see ``sharded_ascent``).

    Returns fn(p8, q8, sigma0, delta0, eta0, read_base, site_mask,
    conserved) → (sigma, delta, eta, prob) on the first device. Cell data
    arrives in compact form (int8 allele + uint8 baseq); each shard expands
    only its own rows."""
    devs = _devices(mesh)

    def fn(p8, q8, sigma0, delta0, eta0, read_base, site_mask, conserved):
        with held_shards(devs, p8, q8, read_base, site_mask) as sh:
            return sharded_ascent(sh, sigma0, delta0, eta0, site_mask,
                                  conserved, with_genotype, keep_conserved)

    return fn


def _round_counts(n_rounds) -> np.ndarray:
    if isinstance(n_rounds, torch.Tensor):
        n_rounds = n_rounds.cpu().numpy()
    return np.asarray(n_rounds, np.int64).reshape(-1)


def _bucket_values(batch: BatchedRegions, n_rounds, keys,
                   n_loop: Optional[int]) -> Tuple[dict, int]:
    """A bucket program's inputs (the compact cells, masks, round counts,
    keys, and the rounds its loop runs: the most of any member, or
    ``n_loop`` where that is more) and that loop's length."""
    B = batch.p.shape[0]
    rounds = _round_counts(n_rounds)
    if rounds.shape[0] != B or len(keys) != B:
        raise ValueError(f"{B} regions need {B} round counts and keys, got "
                         f"{rounds.shape[0]} and {len(keys)}")
    loop = int(rounds.max()) if B else 0
    if n_loop is not None:
        loop = max(loop, int(n_loop))
    words = np.asarray(keys, np.uint32).astype(np.int64).reshape(B, 2)
    values = dict(p=batch.p, q=batch.q, read_base=batch.read_base,
                  site_mask=batch.site_mask, conserved=batch.conserved,
                  rounds=torch.as_tensor(rounds), keys=torch.as_tensor(words),
                  n_loop=torch.tensor(loop, dtype=torch.int64))
    return values, loop


def _batched_perturbation_impl(batch: BatchedRegions, best_sigma, best_delta,
                               best_eta, best_prob, n_rounds,
                               keys: Sequence[np.ndarray], with_iters: bool,
                               split: bool, n_loop: Optional[int] = None):
    """Shared body of batched_perturbation_phase and its _stats variant: one
    device program (``graphs.run``) of the table build, every round's draws
    and the schedule's loop. ``n_loop``: the rounds the loop runs (default:
    the most of any member; a row of a mesh runs the whole bucket's). With
    ``with_iters`` the trips of each ascent call (2 a round) are returned as
    a list after the state."""
    if with_iters and not O.USE_FAST_KERNELS:
        raise RuntimeError("iteration accounting needs the fast-kernel ascent")
    B, K = best_sigma.shape
    I = best_delta.shape[1]
    dev = best_sigma.device
    values, loop = _bucket_values(batch, n_rounds, keys, n_loop)
    values.update(best_sigma=best_sigma, best_delta=best_delta,
                  best_eta=best_eta,
                  best_prob=O._as_value(best_prob, f64).reshape(B))
    cap = max(O._draw_rounds(I), loop)

    def make():
        z, inputs = O._schedule_namespace(values, (B,), K, I, cap, dev)

        def prologue():
            # the ascent tables are built once for the whole schedule: the
            # active-read set is schedule-invariant (σ only flips sign)
            b = BatchedRegions(z.p, z.q, z.read_base, z.site_mask,
                               z.conserved)
            if O.USE_FAST_KERNELS:
                z.steps = O._fast_steps(_tables(b, z.best_sigma, split),
                                        z.read_base, z.best_sigma,
                                        z.site_mask, z.conserved, False,
                                        False, split)
            else:
                z.steps = O._spec_steps(expand_cells(b.cells), z.read_base,
                                        z.site_mask, z.conserved, False,
                                        False)
            # every round's randoms of every region, drawn on the device in
            # one launch from the regions' own keys at the padded sizes:
            # (t, b) draws are those of fold_in(keys[b], t) → split →
            # uniform, whatever the bucket holds
            O._schedule_start(z, PhaseState(z.best_sigma, z.best_delta,
                                            z.best_eta), z.best_prob)

        nodes = ((graphs.Piece("start", prologue),)
                 + O._schedule_loop(z, z.rounds))
        return graphs.Program(dev, inputs, nodes, (*z.best, z.prob, z.trips))

    kind = ("bucket_schedule", split, O.USE_FAST_KERNELS, O.ASCENT_CHUNK, cap)
    sg, dl, et, prob, trips = graphs.run(kind, dev, make, values,
                                         capture=O.USE_FAST_KERNELS)
    out = (sg, dl, et, prob)
    # every trip of a bucket's ascent moves all B members' tables: the
    # trips of the slowest member of each ascent call (2 a round) are the
    # unit of the accounting, copied back once
    return out + (trips[:loop].reshape(-1).tolist(),) if with_iters else out


def _bucket_loop(n_rounds) -> int:
    """The rounds a bucket's schedule runs: the most of any member."""
    rounds = _round_counts(n_rounds)
    return int(rounds.max()) if rounds.size else 0


def _perturbation_on_mesh(mesh: Mesh, batch, best_sigma, best_delta,
                          best_eta, best_prob, n_rounds, keys,
                          with_iters: bool, split: Optional[bool]):
    """The schedule over the rows of a mesh, every row running the whole
    bucket's loop. With ``with_iters`` the trips of each ascent call are
    the most of any row's (the bucket's slowest member), summed over the
    calls: the count of the schedule without a mesh."""
    loop = _bucket_loop(n_rounds)
    states = (best_sigma, best_delta, best_eta,
              torch.as_tensor(best_prob, dtype=f64, device=best_sigma.device))

    def row(i, b, sg, dl, et, pr, nr, ks):
        out = _batched_perturbation_impl(b, sg, dl, et, pr, nr, ks,
                                         with_iters, _split(b, split),
                                         n_loop=loop)
        return out[:4] + ((torch.as_tensor(out[4]),) if with_iters else ())

    out = _on_mesh(mesh, batch, row,
                   (*states, _round_counts(n_rounds), list(keys)))
    if not with_iters:
        return out
    if not loop:
        return out[:4] + (0,)
    # the rows' trip lists, joined one after another: [rows, calls]
    per_call = out[4].reshape(-1, 2 * loop)
    return out[:4] + (int(per_call.max(dim=0).values.sum()),)


def batched_perturbation_phase(batch: BatchedRegions, best_sigma, best_delta,
                               best_eta, best_prob, n_rounds, keys,
                               split: Optional[bool] = None,
                               mesh: Optional[Mesh] = None):
    """The perturbation schedule (phase.rs:1198-1233) over a region bucket:
    a loop to max(n_rounds) in which a member with t >= n_rounds[b] keeps
    its state.

    ``keys`` holds one threefry key (``rng.prng_key``) per region, so each
    region's perturbation stream depends only on its own seed — never on
    which other regions share its bucket or wave. Returns (sigma, delta,
    eta, prob[B]) of the per-region best states."""
    if mesh is not None:
        return _perturbation_on_mesh(mesh, batch, best_sigma, best_delta,
                                     best_eta, best_prob, n_rounds, keys,
                                     False, split)
    return _batched_perturbation_impl(batch, best_sigma, best_delta, best_eta,
                                      best_prob, n_rounds, keys, False,
                                      _split(batch, split))


def batched_perturbation_phase_stats(batch: BatchedRegions, best_sigma,
                                     best_delta, best_eta, best_prob,
                                     n_rounds, keys,
                                     split: Optional[bool] = None,
                                     mesh: Optional[Mesh] = None):
    """batched_perturbation_phase plus the count of ascent trips: returns
    (sigma, delta, eta, prob[B], iters) where ``iters`` sums, over the
    ascent calls, the trips of the member that took most — each such trip
    streams every region's Dp twice (rows and cols matvec). States and
    probs are those of batched_perturbation_phase. Fast-kernel path only.
    With a mesh, ``iters`` is the same count: per call the most of any
    row's trips."""
    if mesh is not None:
        return _perturbation_on_mesh(mesh, batch, best_sigma, best_delta,
                                     best_eta, best_prob, n_rounds, keys,
                                     True, split)
    *out, trips = _batched_perturbation_impl(
        batch, best_sigma, best_delta, best_eta, best_prob, n_rounds, keys,
        True, _split(batch, split))
    return tuple(out) + (sum(trips),)


def batched_overall_probability(batch: BatchedRegions, sigma, delta, eta,
                                split: Optional[bool] = None,
                                mesh: Optional[Mesh] = None):
    """cal_overall_probability per region of a bucket → prob[B]. In split
    mode via the split tables (the scale of the split-mode ascent
    objectives it is compared against); in f64 the exact spec kernel."""
    if mesh is not None:
        return _on_mesh(mesh, batch, lambda i, b, sg, dl, et: (
            batched_overall_probability(b, sg, dl, et, split),),
            (sigma, delta, eta))[0]
    if O.USE_FAST_KERNELS and _split(batch, split):
        ft = _tables(batch, sigma, True)
        return KF.fast_overall_probability32(ft, sigma, delta, eta)
    rm = batch.read_base & (sigma != 0)
    return overall_probability(expand_cells(batch.cells), sigma, delta, eta,
                               rm, batch.site_mask)


def _flip_and_score(fts, batch: BatchedRegions, sigma, delta, eta, block_id):
    sg2, dl2, margin = KF.fast_block_flip32(fts, batch.p, sigma, delta, eta,
                                            batch.site_mask, block_id)
    # the flip never zeroes σ, so the tables' active-read set is still exact
    prob2 = KF.fast_overall_probability32(fts, sg2, dl2, eta)
    return sg2, dl2, prob2, margin


def _need_split(batch, split: Optional[bool], what: str):
    if not (O.USE_FAST_KERNELS and _split(batch, split)):
        raise RuntimeError(f"{what} requires the f32 split tables")


def batched_block_flip(batch: BatchedRegions, sigma, delta, eta, block_id,
                       split: Optional[bool] = None,
                       mesh: Optional[Mesh] = None):
    """Device block-flip pass (phase.rs:1298-1394) over a region bucket.

    Split mode only (the split tables are the operands): callers run
    ``optimize.block_flip_pass`` on the host otherwise. ``block_id`` is
    [B,I] int (−1 = unblocked or padded column). Returns (new_sigma,
    new_delta, prob2[B], margin[B]): ``prob2`` scores the flipped state
    with the expression and the tables of batched_overall_probability's
    split branch; a region with margin < F32_BF_TOL had a near-tie block
    decision and must be recomputed with the exact host pass."""
    _need_split(batch, split, "the device block flip")
    if mesh is not None:
        return _on_mesh(mesh, batch, lambda i, b, sg, dl, et, bid:
                        batched_block_flip(b, sg, dl, et, bid, True),
                        (sigma, delta, eta, block_id))
    fts = _tables(batch, sigma, True)
    return _flip_and_score(fts, batch, sigma, delta, eta, block_id)


def batched_phase_fused(batch: BatchedRegions, sigma0, delta0, eta0,
                        block_id, n_rounds, keys,
                        split: Optional[bool] = None,
                        mesh: Optional[Mesh] = None):
    """The bucket's entire iterative phase — first ascent (keep_conserved,
    phase.rs:1132) → block flip and flip score → keep-best → perturbation
    schedule — over one split-table build (split mode only).

    Every stage is the computation the staged chain runs
    (batched_cross_optimize / batched_block_flip / keep-best /
    batched_perturbation_phase), composed: outputs are bit-identical, so
    the caller may choose fused or staged per bucket. Returns (sigma,
    delta, eta, prob[B], margin[B]); when any region's margin is inside the
    f32 envelope the caller discards the result and reruns the staged
    path, whose host-exact block flip defines the semantics. With a mesh
    the margins of every row come back, so the caller decides for the
    whole bucket."""
    _need_split(batch, split, "the fused phase")
    loop = _bucket_loop(n_rounds)
    if mesh is not None:
        return _on_mesh(mesh, batch, lambda i, b, *a: _phase_fused(
            b, *a, n_loop=loop), (sigma0, delta0, eta0, block_id,
                                  _round_counts(n_rounds), list(keys)))
    return _phase_fused(batch, sigma0, delta0, eta0, block_id, n_rounds,
                        keys, loop)


def _phase_fused(batch: BatchedRegions, sigma0, delta0, eta0, block_id,
                 n_rounds, keys, n_loop: int):
    """batched_phase_fused on one device, its schedule running ``n_loop``
    rounds: one device program (``graphs.run``) of the table build, the
    first ascent, the block flip and keep-best, the draws and the
    schedule's loop."""
    B, K = sigma0.shape
    I = delta0.shape[1]
    dev = sigma0.device
    values, loop = _bucket_values(batch, n_rounds, keys, n_loop)
    values.update(sigma0=sigma0, delta0=delta0, eta0=eta0, block_id=block_id)
    cap = max(O._draw_rounds(I), loop)

    def make():
        z, inputs = O._schedule_namespace(values, (B,), K, I, cap, dev)
        st1 = PhaseState(*(torch.zeros_like(a) for a in z.best))
        active1 = torch.zeros(B, dtype=torch.bool, device=dev)
        count1 = torch.zeros((), dtype=torch.int64, device=dev)
        margins = torch.zeros(B, dtype=f64, device=dev)

        def tables():
            # one build serves every stage: the active-read mask it bakes
            # in (read_base & σ≠0) is σ-sign-invariant across the sequence
            z.batch = BatchedRegions(z.p, z.q, z.read_base, z.site_mask,
                                     z.conserved)
            z.fts = _tables(z.batch, z.sigma0, True)
            z.steps1 = O._fast_steps(z.fts, z.read_base, z.sigma0,
                                     z.site_mask, z.conserved, False, True,
                                     True)
            z.steps = O._fast_steps(z.fts, z.read_base, z.sigma0,
                                    z.site_mask, z.conserved, False, False,
                                    True)
            # the first ascent (keep_conserved, phase.rs:1132)
            O._assign(st1, PhaseState(z.sigma0, z.delta0, z.eta0))
            active1.fill_(True)
            count1.zero_()
            ascend1()

        def ascend1():
            z.more.copy_(O._trips(st1, active1, count1, z.steps1[0],
                                  z.steps1[1], O.ASCENT_CHUNK))

        def flip():
            prob1 = z.steps1[2](st1)
            sg2, dl2, prob2, mg = _flip_and_score(
                z.fts, z.batch, st1.sigma, st1.delta, st1.eta, z.block_id)
            margins.copy_(mg)
            # keep-best, tie-quantized like the staged chain's host
            # comparison: when no block flips, prob2 re-scores the same
            # state, and an unquantized > would resolve by summation-order
            # rounding
            better = prob2 > prob1 + TIE_TOL
            O._schedule_start(
                z, PhaseState(torch.where(better[:, None], sg2, st1.sigma),
                              torch.where(better[:, None], dl2, st1.delta),
                              st1.eta), torch.where(better, prob2, prob1))

        nodes = ((graphs.Piece("tables", tables),
                  graphs.While(z.more, (graphs.Piece("ascent", ascend1),)),
                  graphs.Piece("blockflip", flip))
                 + O._schedule_loop(z, z.rounds))
        return graphs.Program(dev, inputs, nodes, (*z.best, z.prob, margins))

    kind = ("fused", O.ASCENT_CHUNK, cap)
    return graphs.run(kind, dev, make, values)


def batched_enum_cross_optimize(batch: BatchedRegions, sigma0, configs, eta0,
                                split: Optional[bool] = None,
                                mesh: Optional[Mesh] = None):
    """Enumeration path over a bucket: regions axis × configs axis.

    sigma0 [B,C,K] per-region per-config random inits; configs [C,I] shared
    (regions of a bucket have the same logical candidate count); eta0
    [B,I]. One ascent program (``optimize._ascent``) builds each region's
    tables once and its C configs share them — the hand kernels read table
    b for the C members of region b; each region's configs must share its
    active-read set (checked before the program runs). Returns (sigma,
    delta, eta)[B,C,...] and prob[B,C]. With a mesh, ``sigma0`` and
    ``eta0`` are cut with the regions and ``configs`` goes whole to every
    row."""
    if mesh is not None:
        return _on_mesh(mesh, batch, lambda i, b, sg0, et0, cf:
                        batched_enum_cross_optimize(b, sg0, cf, et0, split),
                        (sigma0, eta0), (configs,))
    B, C, K = sigma0.shape
    I = configs.shape[-1]
    st0 = PhaseState(sigma0, configs.to(f64).expand(B, C, I),
                     eta0[:, None, :].expand(B, C, I))
    st, prob, _ = O._ascent(batch.cells, st0, batch.read_base,
                            batch.site_mask,
                            torch.zeros_like(batch.site_mask), True, False,
                            _split(batch, split), O.USE_FAST_KERNELS)
    return st.sigma, st.delta, st.eta, prob
