"""The phasing ascent's split-Dp contractions: CUDA kernels + plain versions.

Counterpart of ``longcallr_tpu/phasing/pallas_kernels.py``. ``Dp`` is one
region's emission matrix stored as an exact two-term f32 split ``hi + lo``
(see kernels_fast.py). Two contractions carry the ascent:

* ``dual_matvec_rows(hi, lo, x)``: ``Dp·x`` for x [I, 2] (both operand
  columns u, v in one pass) — the σ half-step and the objective;
* ``matvec_cols(hi, lo, s)``: ``Dpᵀ·s`` — the (δ, η) half-step and the
  block-flip pass.

Both take a batch of members (state vectors) over a batch of tables:
hi/lo [K,I] shared by every member (one region's enumeration configs share
one Dp), hi/lo [B,K,I] with one member per table (a bucket of regions), or
hi/lo [B,K,I] with an operand [B,C,...] (a bucket of regions with C
configs each). The kernels are told the members per table and member m
reads table m // g; no table is expanded. On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/split_matvec.cu`` (built at first use, see ``_build.py``) or raises;
on a CPU tensor it takes the plain version, ``(hi.double() + lo.double())``
contracted in f64. The kernel accumulates in f64, so it agrees with the
plain version up to summation order.

``dual_matvec_rows`` reads each table once per launch, whatever the members
per table: a block owns a tile of rows of one table, keeps those cells on
the SM (I <= 32: a whole row per thread in registers, widened to f64 once;
wider rows: one warp per row, its cells in shared memory when the block
serves more than one member) and walks the members of that table, whose x
it stages in shared memory. The members are walked inside the block, so
their number is not bound by the 65,535 of the grid's second and third
dimension: the second holds the chunks a table's members are cut into, at
most a few per SM, the third the tables (and the batch of ``matvec_cols``),
which go in as many launches as that takes, inside the C entry points.
``rows_plan`` picks the block's shape from (tables, K, I, members per
table). The order of a member's sum depends on I alone, so a member's
result among g members of a table equals its result alone, bit for bit.

``matvec_cols`` has two kernels, chosen by the table's width alone
(``cols_path``). Up to COLS_WALK_MAX_I columns, at every number of members
per table, the walk: a block walks a chunk of one table's members and
streams the table through shared memory once (bulk copies, the next stage
in flight while one is widened and summed), each thread on 2 columns of up
to 4 members; a launch of one member a block (one member per table) takes
the direct form: a cluster of up to 16 CTAs splits the member's rows, each
CTA copying its stage in with bulk copies a tile and summing it from the
raw rows. ``cols_walk_plan`` picks the launch shape. A
member's sum is its 16-row chains (each an fma chain from 0) added into
64-row tiles and the tiles into the sum, in row order, whatever the plan or
the form, so its result among g members equals its result alone, bit for
bit. Wider tables (the deep and stream buckets, one member per table) keep
the strip: one block per column block, K chunk and member, the K chunks
combined in chunk order (``cols_plan``).

A call costs little beside its kernel: dtype, shape, device and contiguity
are checked, but contiguous operands are not copied, no device context is
entered (the C entry point selects the device) and the only allocation is
the result. A strided or broadcast operand is first made contiguous.

The strip needs scratch on the card when K is cut into chunks: the
chunks' partial sums and one ticket per column block (the walk needs none). It is kept per
(device, stream) in ``_WORKSPACES`` and reused by every call, which is safe
because launches on one stream run in order: two host threads that share a
stream share a workspace and their kernels serialise; threads on different
streams get different workspaces.

``LAUNCHES`` counts kernel launches per wrapper (plain-version calls are not
counted), so a run can show that its main path went through the kernels;
``LAUNCH_SHAPES`` holds the (tables, K, I, members per table) of those
launches, so the run can also show at which shapes, and
``LAUNCHES_BY_SHAPE`` how many at each. ``LAUNCHES_BY_DEVICE``
counts them per card (device index) and ``LAUNCHES_BY_ROW`` per row of a
regions mesh: ``parallel/mesh.py`` names the row of each thread it runs
(``set_launch_row``), so a run can show that every row launched, also
where the rows repeat one card. ``reset_launches`` clears all five, the
graph counters below and the round draws' counts (``cuda_draws``).

Under CUDA graph capture (``phasing/graphs.py``) a wrapper's launch becomes
a node of a piece of a device program and runs only when the program runs,
as many times as the loop that holds the piece turns: the capture records
each launch instead of counting it (``recording``), and after a program's
run the host adds each piece's recorded launches times the runs of that
piece, read from the device once with the outputs, for the row of the
thread that ran the program (``count_runs``). So a run counts the same
launches with the program as without. ``GRAPHS`` counts the program
launches, builds, piece captures, the seconds the captures and the
instantiations took, the device bytes the built programs hold, the
programs freed beyond the budget, the body runs of their loops, the
launches of the set-condition kernel (the device's own count) and the host
reads of a loop flag (the plain executor's; a program makes none),
``GRAPH_LAUNCHES`` the launches that
program runs added, ``GROUPS`` the launches of groups of programs (one
program per shard of the reads-sharded ascent) and the barrier turns their
exchanges counted on the device. A capture's cols workspace (it runs on a
stream of its own) is taken out of ``_WORKSPACES`` afterwards and kept by
its program
(``take_workspaces``): a later call that grows the workspace of that stream
would otherwise free memory that the program writes at every run.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Optional, Set, Tuple

import torch

LAUNCHES = {"dual_matvec_rows": 0, "matvec_cols": 0}
LAUNCH_SHAPES: Dict[str, Set[Tuple[int, int, int, int]]] = {
    "dual_matvec_rows": set(), "matvec_cols": set()}
LAUNCHES_BY_SHAPE: Dict[Tuple[str, Tuple[int, int, int, int]], int] = {}
LAUNCHES_BY_DEVICE: Dict[int, Dict[str, int]] = {}
LAUNCHES_BY_ROW: Dict[int, Dict[str, int]] = {}
# device programs of the phase (phasing/graphs.py): launches, builds, piece
# captures and their seconds, instantiation seconds, device bytes held,
# programs freed beyond the budget, loop body runs, launches of the
# set-condition kernel, host reads of a loop flag, and the wall seconds of
# the launches from the card's lock requested to the sync (the spans
# ``programs.run``); and the launches that program runs added to LAUNCHES
_GRAPHS_ZERO = {"launches": 0, "builds": 0, "captures": 0,
                "capture_seconds": 0.0, "instantiate_seconds": 0.0,
                "bytes_held": 0, "evicted": 0, "body_runs": 0,
                "condition_sets": 0, "flag_reads": 0, "run_seconds": 0.0}
GRAPHS = dict(_GRAPHS_ZERO)
# groups of device programs, one per shard (phasing/graphs.py, Group: the
# reads-sharded ascent): group launches, and the shards' barrier turns at
# their exchanges, counted on the device (each shard's own count, summed)
_GROUPS_ZERO = {"launches": 0, "barrier_turns": 0}
GROUPS = dict(_GROUPS_ZERO)
GRAPH_LAUNCHES = {"dual_matvec_rows": 0, "matvec_cols": 0}
_count_lock = threading.Lock()
# the mesh row on whose behalf a thread launches (None: no row), and the
# launches a capture in this thread records (None: not capturing)
_launch_row = threading.local()
_recorded = threading.local()

# the cols strip's block (cols_kernel, I > 32): 256 threads, 4 rows in
# flight per thread, at most 1024 rows of σ staged per block
# (csrc/split_matvec.cu)
COLS_THREADS = 256
COLS_UNROLL = 4
COLS_MAX_CHUNK = 1024
# widest block in column threads (log2), by columns per thread: 16 threads of
# 4 columns, or 32 threads of 1
COLS_MAX_TX_LOG2 = {4: 4, 1: 5}
# blocks per SM the cols grid aims for
COLS_BLOCKS_PER_SM = 2
# a block's strip of hi + lo (K rows by its columns) up to this size is not
# cut into K chunks: ticket and combine cost about 2.3 µs on an H100, as
# long as one SM takes to stream some 128 KiB
COLS_SPLIT_MIN_BYTES = 128 << 10
# the rows kernel's block: at most 256 threads (log2: 8), row threads by
# member ways; one thread keeps a row of up to 32 cells, wider rows get a
# warp each, 8 a block (csrc/split_matvec.cu)
ROWS_THREADS_LOG2 = 8
ROWS_WALK_MAX_I = 32
ROWS_LANE_ROWS = 8
# blocks per SM the rows grid aims for when it cuts a table's members into
# chunks: on an H100 one block per SM was best or within 10 % of it at
# every enumeration shape (experiments/torch_rows_variants.py); finer chunks
# read the table more often, coarser ones leave SMs idle
ROWS_BLOCKS_PER_SM = 1
# CUDA's limit on the grid's second and third dimension (the cols kernel's K
# chunks lie on the second)
_GRID_YZ_MAX = 65535
# the cols walk (csrc/split_matvec.cu cols_walk_kernel) takes tables of up
# to COLS_WALK_MAX_I columns, at every number of members per table: a
# member's sum then runs in one order whether it is alone on its table or
# among g; wider tables keep the strip (cols_kernel). One member per table
# takes the walk's direct form: on an H100 at 700 W, 4.20 / 4.47 µs warm /
# cold at (1, 4096, 16; 1) against the strip's 5.60 / 5.97, 4.05 / 4.53 at
# (5, 2048, 32; 1) against 5.22 / 5.95, ahead at every one-member shape
# timed but (1, 4096, 32; 1): 5.71 / 6.03 against 5.16 / 5.87, a cluster's
# 16 CTAs against the strip's 32 (experiments/torch_cols_variants.py
# --one-member)
COLS_WALK_MAX_I = 32
# the walk's order: a member's chains of 16 rows, each summed from 0, are
# added in row order into tiles of 64 rows, the tiles in row order
COLS_WALK_CHAIN = 16
COLS_WALK_TILE = 64
# most threads of a walk block; stage buffers a block aims for (one summed,
# the others in flight)
COLS_WALK_THREADS = 256
COLS_WALK_BUFS = 2
# fewest members a block of the walk takes where the table has them (a
# table of fewer members is one block)
COLS_WALK_MIN_MEMBERS = 8
# blocks per SM the walk grid aims for when it cuts a table's members into
# chunks (each chunk reads the table once): on an H100 half the members a
# block took 12.8 µs at (4, 512, 16; 512) against 9.0 µs
# (experiments/torch_cols_variants.py)
COLS_WALK_BLOCKS_PER_SM = 1
# rows a stage aims for (whole tiles) where K does not fit one stage: 256
# rows in 2 buffers was the best of 64 to 512 rows in 1 to 3 buffers at the
# transcriptome input's shapes (the same script)
COLS_WALK_STAGE_ROWS = 256
# dynamic shared memory a block may have on an H100 (227 KB)
MAX_DYN_SHARED = 232448
# the direct form (one member a block): most CTAs of a cluster (more than 8
# is not portable, and is allowed on the kernel), and its static shared
# memory: a chain's partials a thread, a round's tiles a cluster and an
# mbarrier a tile of a stage
COLS_WALK_MAX_CLUSTER = 16
# members in all, for each SM, up to which the direct form serves a call
# even where members share a table (each member reads its table alone): on
# an H100 at 700 W, (1, 512, 8; 64) 3.68 / 4.27 µs warm / cold against the
# staged walk's 5.00 / 5.45 and the strip's 3.77 / 4.55; at 256 members,
# (4, 512, 8; 64), 5.57 / 5.96 against the staged walk's 5.07 / 5.63
# (experiments/torch_cols_variants.py --walk-only --no-sweep)
COLS_WALK_DIRECT_MEMBERS_PER_SM = 1
COLS_WALK_DIRECT_STATIC = 8 * (2 * COLS_WALK_THREADS
                               + COLS_WALK_MAX_CLUSTER * COLS_WALK_THREADS // 2
                               + COLS_WALK_THREADS // 4)


def reset_launches() -> None:
    from .cuda_draws import reset_draw_launches
    from .cuda_exchange import reset_exchange_launches
    from .cuda_keep_best import reset_keep_best_launches

    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            LAUNCH_SHAPES[k].clear()
        LAUNCHES_BY_SHAPE.clear()
        LAUNCHES_BY_DEVICE.clear()
        LAUNCHES_BY_ROW.clear()
        GRAPHS.update(_GRAPHS_ZERO)
        GROUPS.update(_GROUPS_ZERO)
        for k in GRAPH_LAUNCHES:
            GRAPH_LAUNCHES[k] = 0
    reset_draw_launches()
    reset_exchange_launches()
    reset_keep_best_launches()


def set_launch_row(row: Optional[int]) -> None:
    """Count this thread's launches for row ``row`` of a regions mesh from
    now on (None: for no row)."""
    _launch_row.index = row


def _count(name: str, hi: torch.Tensor, g: int, device_index: int) -> None:
    """One launch of ``name`` on tables ``hi`` with g members per table, on
    the card ``device_index``; under capture, recorded for the replays."""
    shape = (hi.shape[0] if hi.dim() == 3 else 1, hi.shape[-2], hi.shape[-1],
             g)
    rec = getattr(_recorded, "launches", None)
    if rec is not None:
        rec.append((name, shape, device_index))
        return
    _add([(name, shape, device_index)])


def _add(launches, n: int = 1) -> None:
    """Count ``launches`` ((name, shape, device index) each; the round
    draws' go to ``cuda_draws``, the shard exchange's to ``cuda_exchange``,
    the keep-best's to ``cuda_keep_best``) ``n`` times for this thread's
    row."""
    from .cuda_draws import add_draw_launches
    from .cuda_exchange import add_exchange_launches
    from .cuda_keep_best import add_keep_best_launches

    row = getattr(_launch_row, "index", None)
    with _count_lock:
        for name, shape, device_index in launches:
            if name == "shard_exchange":
                add_exchange_launches(n)
                continue
            if name == "keep_best":
                add_keep_best_launches(n)
                continue
            if name not in LAUNCHES:
                add_draw_launches(shape, n)
                continue
            LAUNCHES[name] += n
            LAUNCH_SHAPES[name].add(shape)
            LAUNCHES_BY_SHAPE[name, shape] = \
                LAUNCHES_BY_SHAPE.get((name, shape), 0) + n
            for table, key in ((LAUNCHES_BY_DEVICE, device_index),
                               (LAUNCHES_BY_ROW, row)):
                if key is not None:
                    table.setdefault(key, dict.fromkeys(LAUNCHES, 0))[name] += n


@contextlib.contextmanager
def recording():
    """Record the launches of this thread instead of counting them (a
    capture): yields the list they are appended to."""
    rec = []
    _recorded.launches = rec
    try:
        yield rec
    finally:
        _recorded.launches = None


def count_runs(launches, n: int) -> None:
    """``n`` runs, inside a device program, of a piece whose capture
    recorded ``launches``."""
    if n <= 0:
        return
    _add(launches, n)
    with _count_lock:
        for name, _, _ in launches:
            if name in GRAPH_LAUNCHES:
                GRAPH_LAUNCHES[name] += n


def count_graphs(**amounts) -> None:
    """Add ``amounts`` to the ``GRAPHS`` counters of the same names."""
    with _count_lock:
        for k, v in amounts.items():
            GRAPHS[k] += v


def count_groups(**amounts) -> None:
    """Add ``amounts`` to the ``GROUPS`` counters of the same names."""
    with _count_lock:
        for k, v in amounts.items():
            GROUPS[k] += v


def _widen(hi, lo, lead: int) -> torch.Tensor:
    """(hi + lo) in f64, shaped to broadcast against an operand with
    ``lead`` leading axes: a batch of tables under a [B, C, ...] operand
    gets an axis for the members of each table."""
    dp = hi.double() + lo.double()
    return dp[:, None] if (dp.dim() == 3 and lead == 2) else dp


def _grouped(op, tables: int, members_per_table, vec_dims: int):
    """A flat [M, ...] operand as [tables, members per table, ...]."""
    if members_per_table is None:
        return op
    return op.reshape(tables, int(members_per_table), *op.shape[-vec_dims:])


def dual_matvec_rows_plain(hi, lo, x, members_per_table=None) -> torch.Tensor:
    """Plain PyTorch version: (hi + lo) in f64 times x → [..., K, 2]. Takes
    the shapes the wrapper takes."""
    xg = _grouped(x.double(), hi.shape[0] if hi.dim() == 3 else 1,
                  members_per_table, 2)
    out = torch.matmul(_widen(hi, lo, xg.dim() - 2), xg)
    return out if members_per_table is None else out.reshape(
        x.shape[0], hi.shape[-2], 2)


def matvec_cols_plain(hi, lo, s, members_per_table=None) -> torch.Tensor:
    """Plain PyTorch version: sᵀ·(hi + lo) in f64 → [..., I]. Takes the
    shapes the wrapper takes."""
    sg = _grouped(s.double(), hi.shape[0] if hi.dim() == 3 else 1,
                  members_per_table, 1)
    out = torch.matmul(sg.unsqueeze(-2),
                       _widen(hi, lo, sg.dim() - 1)).squeeze(-2)
    return out if members_per_table is None else out.reshape(
        s.shape[0], hi.shape[-1])


def _operands(hi, lo, op, vec_dims: int, members_per_table=None):
    """Check hi/lo and the operand (``vec_dims`` trailing dims: [I,2] or
    [K]) and bring them to what the kernels take: M members over a batch
    of tables, member m on table m // g. Returns (M, g, the operand as
    contiguous memory, the result's leading shape).

    Accepted: tables [K,I] with an operand that has no or one leading axis
    (all members share the one table); tables [B,K,I] with an operand that
    has none (one operand for every table), [B, ...] (a table per member),
    or [B, C, ...] (C members per table). ``members_per_table`` names g for
    a flat operand [B·g, ...] over tables [B,K,I]."""
    hs, ops = hi.shape, op.shape
    hd = len(hs)
    if hi.dtype is not torch.float32 or lo.dtype is not torch.float32:
        raise TypeError(f"hi/lo must be float32, got {hi.dtype}/{lo.dtype}")
    if op.dtype is not torch.float64:
        raise TypeError(f"the operand must be float64, got {op.dtype}")
    if lo.shape != hs or hd not in (2, 3):
        raise ValueError(f"hi/lo must share a [K,I] or [B,K,I] shape, got "
                         f"{tuple(hs)} / {tuple(lo.shape)}")
    dev = hi.device
    if lo.device != dev or op.device != dev:
        raise ValueError("all operands must be on one device")
    K, I = hs[-2], hs[-1]
    want = (I, 2) if vec_dims == 2 else (K,)
    lead = len(ops) - vec_dims
    if not 0 <= lead <= hd - 1 or tuple(ops[lead:]) != want:
        raise ValueError(f"the operand must be [..., {', '.join(map(str, want))}]"
                         f" with at most {hd - 1} leading axes, got "
                         f"{tuple(ops)}")
    tables = hs[0] if hd == 3 else 1
    lead_shape = tuple(ops[:lead])
    M = 1
    for n in lead_shape:
        M *= n
    if members_per_table is not None:
        g = int(members_per_table)
        if lead != 1:
            raise ValueError("members_per_table goes with a flat [M, ...] "
                             f"operand, got {tuple(ops)}")
        if g < 1 or M != tables * g:
            raise ValueError(f"{M} members are not {tables} tables of "
                             f"{members_per_table} members each")
    elif lead == 0:
        g = 1
        if hd == 3:                     # one operand for a batch of tables
            M, lead_shape = tables, (tables,)
            op = op.expand(tables, *want)
    elif tables == ops[0]:
        g = M // tables if tables else 1
    elif tables == 1:
        g = max(M, 1)
    else:
        raise ValueError(f"batch mismatch: Dp {tables} vs operand "
                         f"{tuple(lead_shape)}")
    if not (hi.is_contiguous() and lo.is_contiguous()):
        raise ValueError("hi and lo must be contiguous")
    if not op.is_contiguous():
        op = op.contiguous()
    return M, g, op, lead_shape


def _ceil_log2(n: int) -> int:
    return max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=4096)
def rows_plan(tables: int, K: int, I: int, g: int, n_sm: int
              ) -> Tuple[int, int, int]:
    """Launch shape of the rows kernel for one call: (log2 of the row
    threads of a block, log2 of its member ways, members of one table that
    a block walks). A row of up to ROWS_WALK_MAX_I cells is one thread's:
    the block is as many row threads as K needs (8 to 256), and the threads
    left of 256 are ways that take every ways-th member; wider rows get a
    warp each, ROWS_LANE_ROWS a block, and one way. A table's g members are
    cut into chunks, a block each, until the grid has about
    ROWS_BLOCKS_PER_SM blocks for each of the card's ``n_sm`` SMs (each
    chunk reads the block's rows of the table again), every way with at
    least one member."""
    if I <= ROWS_WALK_MAX_I:
        rt_log2 = min(ROWS_THREADS_LOG2, max(3, _ceil_log2(K)))
        ways_log2 = min(ROWS_THREADS_LOG2 - rt_log2, _ceil_log2(g))
    else:
        rt_log2, ways_log2 = _ceil_log2(ROWS_LANE_ROWS), 0
    ways = 1 << ways_log2
    row_tiles = -(-K // (1 << rt_log2))
    chunks_wanted = max(1, ROWS_BLOCKS_PER_SM * n_sm
                        // max(1, tables * row_tiles))
    mb = -(-g // chunks_wanted)
    mb = min(g, ways * -(-mb // ways))           # whole turns of the ways
    return rt_log2, ways_log2, mb


@functools.lru_cache(maxsize=4096)
def cols_plan(B: int, K: int, I: int, aligned: bool, n_sm: int
              ) -> Tuple[int, int, int, int, int]:
    """Launch shape of the cols kernel for one call: (columns per thread,
    log2 of the column threads per block, rows per block, column blocks,
    K chunks). ``aligned`` says that hi and lo may be read 16 bytes at a
    time. The K chunk is whole passes of the block (row lanes × unroll):
    all of K where one block's strip of the table is small enough
    (COLS_SPLIT_MIN_BYTES) that cutting it would cost more in ticket and
    combine than it saves, else the number of passes that brings the grid
    nearest to COLS_BLOCKS_PER_SM blocks for each of the card's ``n_sm``
    SMs, and at most COLS_MAX_CHUNK rows."""
    vec = 4 if (aligned and I % 4 == 0) else 1
    tx_log2 = min(COLS_MAX_TX_LOG2[vec], _ceil_log2(-(-I // vec)))
    width = (1 << tx_log2) * vec
    ncb = -(-I // width)
    one_pass = (COLS_THREADS >> tx_log2) * COLS_UNROLL
    if K <= COLS_MAX_CHUNK and K * width * 8 <= COLS_SPLIT_MIN_BYTES:
        return vec, tx_log2, one_pass * -(-K // one_pass), ncb, 1
    chunks_wanted = max(1, COLS_BLOCKS_PER_SM * n_sm // (B * ncb))
    passes = max(1, min((2 * K + one_pass * chunks_wanted)
                        // (2 * one_pass * chunks_wanted),
                        COLS_MAX_CHUNK // one_pass))
    kc = one_pass * passes
    return vec, tx_log2, kc, ncb, -(-K // kc)


def _even(n: int) -> int:
    return n + (n & 1)


def _walk_stage_rows(K: int, stage_tiles: int) -> int:
    """Rows of a walk stage (``WalkLayout``): stage_tiles tiles, or K itself
    (rounded up to even) where one stage holds it."""
    sr = stage_tiles * COLS_WALK_TILE
    return sr if K > sr else _even(K)


def _walk_layout_bytes(K: int, I: int, mb: int, ways: int,
                       stage_tiles: int, bufs: int,
                       widened: bool = True) -> int:
    """Bytes of ``WalkLayout`` (csrc/split_matvec.cu): the stage's rows
    widened to f64 (where ``widened``), the chain partials where the block
    has more than one way, and per stage buffer (no more than there are
    stages) the members' σ, the raw f32 rows and an mbarrier."""
    sr = _walk_stage_rows(K, stage_tiles)
    nb = min(bufs, -(-K // sr))
    chains = stage_tiles * (COLS_WALK_TILE // COLS_WALK_CHAIN)
    doubles = _even(sr * I) if widened else 0
    if ways > 1:
        doubles += _even(chains * (mb * I + 2))
    doubles += nb * (mb * (sr + 2) + _even(sr * I)) + _even(nb)
    return 8 * doubles


def cols_walk_shared_bytes(K: int, I: int, mb: int, ways: int,
                           stage_tiles: int, bufs: int) -> int:
    """Shared memory of one walk block. Staged (mb > 1): its
    ``WalkLayout``, all dynamic. Direct (mb = 1): the layout of one buffer
    of a stage of ``ways`` chains, with no widened copy, and beside it the
    static arrays of the chains' partials and a cluster's tiles
    (COLS_WALK_DIRECT_STATIC)."""
    if mb == 1:
        per_tile = COLS_WALK_TILE // COLS_WALK_CHAIN
        return COLS_WALK_DIRECT_STATIC + _walk_layout_bytes(
            K, I, 1, 1, ways // per_tile, 1, widened=False)
    return _walk_layout_bytes(K, I, mb, ways, stage_tiles, bufs)


def cols_walk_threads(I: int, vec: int, rm: int, mb: int, ways: int) -> int:
    """Threads of one walk block: ways (chains at once) by the members'
    groups (mb / rm; one in the direct form) by column groups."""
    return ways * (1 if mb == 1 else mb // rm) * (I // vec)


def cols_path(I: int) -> str:
    """The cols kernel that serves tables of I columns: "walk" or
    "strip"."""
    return "walk" if I <= COLS_WALK_MAX_I else "strip"


def _cols_direct_plan(members: int, K: int, I: int, n_sm: int
                      ) -> Tuple[int, int, int, int, int, int, int]:
    """The direct form's launch shape for ``members`` members in all:
    clusters of up to COLS_WALK_MAX_CLUSTER CTAs a member, as many as keep
    a tile a CTA and all the clusters on the card at once; a stage of the member's chains a
    CTA, as many as a round of the cluster's stages covers K with where the
    block's threads and shared memory allow; a column a thread, or 2 where
    a column a thread would take more than one round."""
    per_tile = COLS_WALK_TILE // COLS_WALK_CHAIN
    chains = -(-K // COLS_WALK_CHAIN)
    most = lambda v: COLS_WALK_THREADS // (I // v) // per_tile * per_tile
    vec = 2 if (I % 2 == 0
                and chains > COLS_WALK_MAX_CLUSTER * most(1)) else 1
    cl = 1
    while (cl < COLS_WALK_MAX_CLUSTER and 2 * cl * members <= n_sm
           and -(-chains // (2 * cl)) >= per_tile):
        cl *= 2
    ways = max(per_tile, min(-(-chains // (cl * per_tile)) * per_tile,
                             most(vec)))
    while (ways > per_tile and cols_walk_shared_bytes(K, I, 1, ways, 1, 1)
           > MAX_DYN_SHARED):
        ways -= per_tile
    return vec, 1, 1, ways, 1, 1, cl


@functools.lru_cache(maxsize=4096)
def cols_walk_plan(tables: int, K: int, I: int, g: int, n_sm: int
                   ) -> Tuple[int, int, int, int, int, int, int]:
    """Launch shape of the cols walk for one call: (columns per thread,
    members per thread, members a block walks, ways, tiles a stage, stage
    buffers, CTAs a cluster).

    A table's g members are cut into chunks, a block each, until the grid
    has about COLS_WALK_BLOCKS_PER_SM blocks for each of the card's
    ``n_sm`` SMs, with COLS_WALK_MIN_MEMBERS members a block at least
    where the table has them. A thread keeps 2 columns of up to 4
    members, which share each row it reads; ways, each summing other
    chains of 16 rows of a stage, fill the block's COLS_WALK_THREADS
    threads; a stage is all of K where shared memory holds it, else
    COLS_WALK_STAGE_ROWS rows in COLS_WALK_BUFS buffers (fewer where
    shared memory is short). Where a block would walk one member, or the
    call has no more members than COLS_WALK_DIRECT_MEMBERS_PER_SM for each
    SM, the direct form serves every member alone (``_cols_direct_plan``). None of it changes a member's order of
    summation, which COLS_WALK_CHAIN and COLS_WALK_TILE alone set."""
    vec = 2 if I % 2 == 0 else 1
    cg = I // vec
    per_tile = COLS_WALK_TILE // COLS_WALK_CHAIN
    chains = -(-K // COLS_WALK_CHAIN)
    chunks_wanted = max(1, COLS_WALK_BLOCKS_PER_SM * n_sm // max(1, tables))
    mb = max(-(-g // chunks_wanted), min(g, COLS_WALK_MIN_MEMBERS))
    if mb == 1 or tables * g <= COLS_WALK_DIRECT_MEMBERS_PER_SM * n_sm:
        return _cols_direct_plan(tables * g, K, I, n_sm)
    mb = min(mb, COLS_WALK_THREADS // cg)
    # all of K in one stage where shared memory holds it, else stages of
    # COLS_WALK_STAGE_ROWS in COLS_WALK_BUFS buffers
    tiles = -(-K // COLS_WALK_TILE)
    one = cols_walk_shared_bytes(K, I, mb, min(chains, per_tile * tiles),
                                 tiles, 1) <= MAX_DYN_SHARED
    stage_tiles = tiles if one else max(1, min(
        tiles, COLS_WALK_STAGE_ROWS // COLS_WALK_TILE))
    ways_max = min(per_tile * stage_tiles, chains)
    # the most members a thread whose block still has 128 threads
    rm = next((r for r in (4, 2) if mb % r == 0
               and ways_max * (mb // r) * cg >= 128), 1)
    ways = max(1, min(ways_max, COLS_WALK_THREADS // ((mb // rm) * cg)))
    bufs = 1 if one else COLS_WALK_BUFS
    while cols_walk_shared_bytes(K, I, mb, ways, stage_tiles,
                                 bufs) > MAX_DYN_SHARED:
        if bufs > 1:                # fewer buffers, then tiles a stage
            bufs -= 1
        elif stage_tiles > 1:
            stage_tiles -= 1
            ways = min(ways, per_tile * stage_tiles)
        else:
            mb //= 2
            rm = 1 if mb % rm else rm
    return vec, rm, mb, ways, stage_tiles, bufs, 1


_SM_COUNT: Dict[int, int] = {}
# (device index, stream handle) → [partial f64, tickets int32]; see the
# module docstring for why sharing per stream is safe
_WORKSPACES: Dict[Tuple[int, int], list] = {}
_ws_lock = threading.Lock()


def _sm_count(device: torch.device) -> int:
    n = _SM_COUNT.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _SM_COUNT[device.index] = n
    return n


def _stream(device: torch.device) -> int:
    """The raw handle of the stream PyTorch would launch on."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _workspace(device: torch.device, stream: int, n_partial: int,
               n_tickets: int):
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws[0].numel() < n_partial or ws[1].numel() < n_tickets:
        with _ws_lock:
            ws = _WORKSPACES.get(key)
            have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
            if have[0] < n_partial or have[1] < n_tickets:
                # a replaced tensor is freed only after the launches that
                # use it were enqueued, and the allocator reuses it in
                # stream order; the kernel leaves every ticket at zero
                ws = [torch.empty(max(n_partial, 2 * have[0]),
                                  dtype=torch.float64, device=device),
                      torch.zeros(max(n_tickets, 2 * have[1], 1024),
                                  dtype=torch.int32, device=device)]
                _WORKSPACES[key] = ws
    return ws


def take_workspaces(device: torch.device, stream: int) -> list:
    """Remove the cols workspace of (``device``, ``stream``) from
    ``_WORKSPACES`` and return it (empty where there is none): a graph
    captured on that stream keeps it for as long as the graph lives."""
    with _ws_lock:
        ws = _WORKSPACES.pop((device.index, stream), None)
    return [] if ws is None else ws


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    dev = t.device
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def dual_matvec_rows(hi: torch.Tensor, lo: torch.Tensor, x: torch.Tensor,
                     members_per_table=None) -> torch.Tensor:
    """``(hi + lo) @ x`` → [..., K, 2] float64. hi/lo [K,I] or [B,K,I]
    float32; x [I,2], [B,I,2] or [B,C,I,2] float64 (see ``_operands``)."""
    M, g, xc, lead = _operands(hi, lo, x, 2, members_per_table)
    if hi.device.type == "cpu":
        return dual_matvec_rows_plain(hi, lo, x, members_per_table)
    dev = _cuda_device(hi)
    K, I = hi.shape[-2], hi.shape[-1]
    out = torch.empty(lead + (K, 2), dtype=torch.float64, device=dev)
    if K and I and M:
        from .._build import load
        if xc.data_ptr() % 16:          # x is read 16 bytes at a time
            xc = xc.clone()
        hp, lp = hi.data_ptr(), lo.data_ptr()
        rt_log2, ways_log2, mb = rows_plan(M // g, K, I, g, _sm_count(dev))
        err = load().split_dual_matvec_rows(
            hp, lp, g, xc.data_ptr(), out.data_ptr(), M, K, I, rt_log2,
            ways_log2, mb, int(I % 4 == 0 and (hp | lp) % 16 == 0),
            dev.index, _stream(dev))
        if err != 0:
            raise RuntimeError(f"split_dual_matvec_rows launch failed: "
                               f"cudaError {err}")
        _count("dual_matvec_rows", hi, g, dev.index)
    else:
        out.zero_()
    return out


def matvec_cols(hi: torch.Tensor, lo: torch.Tensor, s: torch.Tensor,
                members_per_table=None) -> torch.Tensor:
    """``sᵀ (hi + lo)`` → [..., I] float64. hi/lo [K,I] or [B,K,I] float32;
    s [K], [B,K] or [B,C,K] float64 (see ``_operands``)."""
    if hi.device.type == "cpu":
        _operands(hi, lo, s, 1, members_per_table)
        return matvec_cols_plain(hi, lo, s, members_per_table)
    return _cols_on_card(hi, lo, s, members_per_table,
                         cols_path(hi.shape[-1]), True)


def cols_strip(hi: torch.Tensor, lo: torch.Tensor, s: torch.Tensor,
               members_per_table=None) -> torch.Tensor:
    """``matvec_cols`` by the strip (``cols_kernel``) at any width, also
    where the walk serves (I <= COLS_WALK_MAX_I): the design those shapes
    had before the walk, kept to time the walk against on the same inputs.
    The port's path never calls it, and it counts no launch."""
    if hi.device.type != "cuda":
        raise ValueError("cols_strip runs on a CUDA card only")
    return _cols_on_card(hi, lo, s, members_per_table, "strip", False)


def _cols_on_card(hi, lo, s, members_per_table, path: str,
                  count: bool) -> torch.Tensor:
    """One launch of the cols kernel ``path`` ("walk" or "strip") on the
    card; the launch is counted where ``count``."""
    M, g, sc, lead = _operands(hi, lo, s, 1, members_per_table)
    dev = _cuda_device(hi)
    K, I = hi.shape[-2], hi.shape[-1]
    out = torch.empty(lead + (I,), dtype=torch.float64, device=dev)
    if not (K and I and M):
        return out.zero_()
    from .._build import load
    hp, lp = hi.data_ptr(), lo.data_ptr()
    stream = _stream(dev)
    if path == "walk":
        sp = sc.data_ptr()
        tvec = I % 4 == 0 and (hp | lp) % 16 == 0
        svec = K % 2 == 0 and sp % 16 == 0
        vec, rm, mb, ways, stage_tiles, bufs, cl = cols_walk_plan(
            M // g, K, I, g, _sm_count(dev))
        err = load().split_matvec_cols_walk(
            hp, lp, g, sp, out.data_ptr(), M, K, I, vec, rm, mb, ways,
            stage_tiles, bufs, cl, int(tvec), int(svec), dev.index, stream)
        if err != 0:
            raise RuntimeError(f"split_matvec_cols_walk launch failed: "
                               f"cudaError {err}")
    else:
        vec, tx_log2, kc, ncb, nch = cols_plan(
            M, K, I, (hp | lp) % 16 == 0, _sm_count(dev))
        if nch > _GRID_YZ_MAX:              # K over 67 million rows
            raise ValueError(f"{nch} K chunks exceed the kernel's grid")
        part = tick = 0
        if nch > 1:
            ws = _workspace(dev, stream, M * nch * I, M * ncb)
            part, tick = ws[0].data_ptr(), ws[1].data_ptr()
        err = load().split_matvec_cols(
            hp, lp, g, sc.data_ptr(), part, tick, out.data_ptr(),
            M, K, I, vec, tx_log2, kc, dev.index, stream)
        if err != 0:
            raise RuntimeError(f"split_matvec_cols launch failed: "
                               f"cudaError {err}")
    if count:
        _count("matvec_cols", hi, g, dev.index)
    return out
