"""Device programs of the phase: the port's counterpart of ``jax.jit``.

In the JAX package a bucket's whole iterative phase is one device program
(``jax.jit`` of ``batched_phase_fused``: the table build, a ``while_loop``
ascent, the block flip, and a ``fori_loop`` of perturbation rounds whose
ascents are ``while_loop``s), compiled once per shape; the host issues it
once and reads its result once. A ``Program`` is that program here: a
description of pieces (callables that read and write only tensors the
program owns, and make no host sync) and of ``While`` loops over them, each
loop turning while a bool flag on the device, which its pieces write, is
set.

On a CUDA device (``ENABLED``), a program is built once per shape and kept
(``run``; ``free_all`` drops them): every piece is called once eagerly (a
warm-up that loads the kernels; its launches are not counted), then
captured as a ``torch.cuda.CUDAGraph`` on the card's one capture stream,
all pieces in one memory pool (they never run at the same time); the
``csrc/graph_program.cu`` library composes the captured graphs into one
parent graph, each loop a conditional WHILE node whose body is its pieces
followed by a one-thread kernel that sets the condition from the flag and
counts its own launches and the body's runs, and instantiates it. A call
copies its inputs into the program's buffers, launches the graph once on
the current stream, and syncs once, when it reads the counters back beside
the outputs;
the hand kernels' launches are the pieces' recorded launches times their
runs (``cuda_kernels.count_runs``). No loop flag is read on the host.

On the CPU, where ``ENABLED`` is false, or for a program that must not be
captured (the reference-form ascent), the plain executor walks the same
description: the pieces in order, a loop's flag read on the host before
each turn. Same tensors, same order of operations, same bytes.

A shape has one cached program, which serves one call at a time: threads
(the rows of a regions mesh, the per-region loop's workers) that run one
shape at once take turns on its lock, as they would on the card's. A card
captures, instantiates, runs and destroys one program at a time (one lock
per card, held from a launch to its sync; a ``Launches`` holds it for each
of its launches and for its one sync): with CUPTI attached (after a
torch.profiler session), threads that instantiated, began a capture and
waited on a launch at once on one card hung in the driver. Each program
keeps its pieces' graphs (they own the memory pool), its cols workspaces
(``cuda_kernels.take_workspaces``) and its buffers for as long as it
lives. The programs held count against the bucket budget
(``batch_driver.BUCKET_MAX_BYTES``): beyond it the programs used least
recently are freed (not the one just used, nor one in use), so a run of
many shapes holds about that much at most besides the bucket in flight.

A ``Group`` is one description over the shards of the reads-sharded ascent
(``parallel/mesh.sharded_ascent``), the counterpart of the JAX package's
``shard_map`` program: one ``Program`` per shard, each on its shard's
device (CUDA wants a conditional node's body on one device), the shards
meeting at ``Exchange`` nodes, where each launches the exchange kernel of
``cuda_exchange`` (the psum) inside a piece. A group's launch starts every
shard's program on a stream of its own, under the locks of its cards taken
in device order, and syncs once. Its key in the cache holds every shard's
device.

There is no quiet fallback: on a CUDA device a capture, a composition, an
instantiation or a launch that fails raises. ``ENABLED`` is the one switch,
for an A/B of the programs against the plain executor on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import itertools
import sys
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..utils.spans import span
from . import cuda_kernels as CK

# run the phase programs as device programs on CUDA devices (False: the
# plain executor, for an A/B)
ENABLED = True


class Piece(NamedTuple):
    """Work of a program without a host sync: captured as one graph."""

    name: str
    fn: Callable[[], None]


class While(NamedTuple):
    """``body`` (pieces and loops) runs while the bool scalar ``flag`` on
    the device is set; the node before the loop sets it first."""

    flag: torch.Tensor
    body: tuple


# one record per program built in this process since the last
# reset_builds(): key, seconds of capture and instantiation, bytes held
BUILDS: List[dict] = []

_locks: Dict[int, threading.RLock] = {}
_locks_lock = threading.Lock()


def _card_lock(device: torch.device) -> threading.RLock:
    """The lock under which a card's programs are captured, instantiated,
    run and destroyed: one at a time on a card."""
    with _locks_lock:
        return _locks.setdefault(device.index, threading.RLock())


# one stream per card on which every program is captured. cuBLAS keeps a
# workspace (32 MiB on an H100) for each pair of handle and stream that
# ran a product, for the life of the process, so captures on streams taken
# anew from the pool leave one behind on each stream they come to: a pass
# of 24 builds over the benchmark's transcriptome input peaked at 1,375 MiB
# of device memory that way and at 383 MiB with one capture stream
# (PERF.md).
# Programs run one at a time on a card (``_card_lock``), so those captured
# on one stream can share its workspace.
_capture_streams: Dict[int, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream on which ``device``'s programs are captured (the caller
    holds the card's lock)."""
    with _locks_lock:
        if device.index not in _capture_streams:
            _capture_streams[device.index] = torch.cuda.Stream(device)
        return _capture_streams[device.index]


def _add_graphs(key: str, seconds: float) -> None:
    """A span's seconds into the ``GRAPHS`` counter ``key``."""
    CK.count_graphs(**{key: seconds})


def _loops(nodes, out=None) -> list:
    """The loops of ``nodes``, depth first."""
    out = [] if out is None else out
    for n in nodes:
        if isinstance(n, While):
            out.append(n)
            _loops(n.body, out)
    return out


def _pieces(nodes, out=None) -> list:
    """The distinct pieces of ``nodes`` in the order they first appear."""
    out = [] if out is None else out
    for n in nodes:
        if isinstance(n, While):
            _pieces(n.body, out)
        elif all(n is not p for p in out):
            out.append(n)
    return out


def _raise(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"device program: {what} failed: cudaError {err}")


class Program:
    """A program over ``inputs`` (name → the buffer a call copies its value
    into), ``nodes`` (Piece and While, in order) and ``outputs`` (buffers
    a call returns copies of)."""

    def __init__(self, device: torch.device, inputs: Dict[str, torch.Tensor],
                 nodes: tuple, outputs: tuple):
        self.device = torch.device(device)
        self.inputs = inputs
        self.nodes = tuple(nodes)
        self.outputs = tuple(outputs)
        self.loops = _loops(self.nodes)
        self.pieces = _pieces(self.nodes)
        self._exec = None
        self._graph = None
        # id(piece) → (its captured graph, the launches it recorded)
        self._captured: Dict[int, tuple] = {}
        self._kept: list = []
        # the body runs of each loop, then the set-condition launches
        self.counters = torch.zeros(len(self.loops) + 1, dtype=torch.int64,
                                    device=self.device)
        self.flag_reads = 0
        # (id(buffer), zeros) → its one-dimensional view, or zeros (_flat)
        self._views: Dict[tuple, torch.Tensor] = {}

    # -- inputs ---------------------------------------------------------------

    def load(self, values: Dict[str, object], zero: bool = False) -> None:
        """Copy each input's value into its buffer: the tensors on the
        program's device directly, in one call, host data through pinned
        memory, both without a host sync. A value of the buffer's size in
        one dimension fills it in order, one of fewer elements broadcasts
        over it. ``zero``: the counters are zeroed in the same call."""
        bufs, srcs = [], []
        for name, buf in self.inputs.items():
            v = values[name]
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(v)
            if v.device == buf.device:
                if v.shape != buf.shape and v.numel() == buf.numel():
                    if v.dim() == 1:
                        buf = self._flat(buf)
                    else:
                        v = v.reshape(buf.shape)
                bufs.append(buf)
                srcs.append(v)
            elif v.device.type == "cpu" and buf.device.type == "cuda":
                v = v.to(buf.dtype).pin_memory()
                buf.copy_(v.reshape(buf.shape), non_blocking=True)
            else:
                buf.copy_(v.reshape(buf.shape))
        if zero:
            bufs.append(self.counters)
            srcs.append(self._flat(self.counters, zeros=True))
        if bufs:
            torch._foreach_copy_(bufs, srcs)

    def _flat(self, t: torch.Tensor, zeros: bool = False) -> torch.Tensor:
        """A one-dimensional view of the program's contiguous buffer ``t``
        (``zeros``: a tensor of zeros of its size and type instead), made
        once."""
        key = (id(t), zeros)
        if key not in self._views:
            self._views[key] = (torch.zeros(t.numel(), dtype=t.dtype,
                                            device=t.device) if zeros
                                else t.view(-1))
        return self._views[key]

    # -- the plain executor ---------------------------------------------------

    def run_plain(self) -> List[int]:
        """The description on the host's control: pieces in order, each
        loop's flag read on the host before each turn. Returns the body runs
        of each loop (and keeps the flag reads in ``flag_reads``)."""
        runs = [0] * len(self.loops)
        self.flag_reads = 0
        self._walk(self.nodes, runs)
        return runs

    def _walk(self, nodes, runs) -> None:
        for n in nodes:
            if isinstance(n, Piece):
                self._call(n)
                continue
            i = self._index(n)
            while self._read(n.flag):
                self._walk(n.body, runs)
                runs[i] += 1

    def _read(self, flag: torch.Tensor) -> bool:
        self.flag_reads += 1
        return _read_flag(flag)

    def _call(self, piece: Piece) -> None:
        piece.fn()

    def _index(self, loop: While) -> int:
        return next(k for k, lp in enumerate(self.loops) if lp is loop)

    def piece_runs(self, runs: List[int]) -> Dict[int, int]:
        """id(piece) → how often it ran, from the body runs of each loop:
        a piece outside every loop runs once, a piece in a loop's body as
        often as that body did (summed where a piece stands in several)."""
        out: Dict[int, int] = {}

        def walk(nodes, n):
            for node in nodes:
                if isinstance(node, Piece):
                    out[id(node)] = out.get(id(node), 0) + n
                else:
                    walk(node.body, runs[self._index(node)])

        walk(self.nodes, 1)
        return out

    def condition_sets(self, runs: List[int]) -> int:
        """Launches of the set-condition kernel that a run with these body
        runs makes: one where a loop is reached (as often as the body around
        it runs) and one at the end of each body run; as many as the plain
        executor's flag reads."""
        total = 0

        def walk(nodes, n):
            nonlocal total
            for node in nodes:
                if isinstance(node, While):
                    i = self._index(node)
                    total += n + runs[i]
                    walk(node.body, runs[i])

        walk(self.nodes, 1)
        return total

    # -- the device program ---------------------------------------------------

    def build(self) -> dict:
        """Warm up, capture every piece, compose and instantiate (CUDA)."""
        with span("programs.warm_up", timed=True) as warm:
            with CK.recording():        # the warm-up's launches: not counted
                for p in self.pieces:
                    p.fn()
        return self.compile(warm.seconds)

    def compile(self, warm_seconds: float) -> dict:
        """Capture every piece (warmed up in ``warm_seconds`` just before,
        which the capture seconds count), compose and instantiate."""
        from .._build import load

        dev = self.device
        pool = torch.cuda.graph_pool_handle()
        # the stream is shared: it waits, and captures, under the card's lock
        with _card_lock(dev):
            side = _capture_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            stream = side.cuda_stream
            with torch.cuda.stream(side):
                with span("programs.capture", timed=True) as cap:
                    for p in self.pieces:
                        # a workspace this stream holds stays with its
                        # piece's graph
                        self._kept += CK.take_workspaces(dev, stream)
                        graph = torch.cuda.CUDAGraph(keep_graph=True)
                        with CK.recording() as launches:
                            graph.capture_begin(
                                pool=pool, capture_error_mode="thread_local")
                            try:
                                p.fn()
                            finally:
                                graph.capture_end()
                        self._captured[id(p)] = (graph, launches)
                    self._kept += CK.take_workspaces(dev, stream)
                with span("programs.instantiate", timed=True) as inst:
                    lib = load()
                    g = ctypes.c_void_p()
                    _raise("graph create", lib.gp_graph_create(
                        dev.index, ctypes.byref(g)))
                    self._graph = g.value
                    self._compose(lib, self._graph, self.nodes, None)
                    x = ctypes.c_void_p()
                    _raise("instantiate", lib.gp_instantiate(
                        self._graph, dev.index, ctypes.byref(x)))
                    self._exec = x.value
        return {"capture_seconds": warm_seconds + cap.seconds,
                "instantiate_seconds": inst.seconds,
                "captures": len(self.pieces)}

    def _compose(self, lib, graph, nodes, dep):
        """Append ``nodes`` to ``graph`` after the node ``dep``; returns the
        last node appended."""
        for n in nodes:
            node = ctypes.c_void_p()
            if isinstance(n, Piece):
                raw = self._captured[id(n)][0].raw_cuda_graph()
                _raise("child node", lib.gp_add_child(graph, dep, raw,
                                                      ctypes.byref(node)))
                dep = node.value
                continue
            i = self._index(n)
            handle = ctypes.c_ulonglong()
            _raise("condition handle",
                   lib.gp_handle_create(graph, ctypes.byref(handle)))
            flag = n.flag.data_ptr()
            sets = self.counters.data_ptr() + 8 * len(self.loops)
            _raise("set node", lib.gp_add_set(graph, dep, handle.value, flag,
                                              None, sets,
                                              ctypes.byref(node)))
            body = ctypes.c_void_p()
            loop = ctypes.c_void_p()
            _raise("while node", lib.gp_add_while(
                graph, node.value, handle.value, ctypes.byref(loop),
                ctypes.byref(body)))
            last = self._compose(lib, body.value, n.body, None)
            counter = self.counters.data_ptr() + 8 * i
            _raise("set node", lib.gp_add_set(body.value, last, handle.value,
                                              flag, counter, sets,
                                              ctypes.byref(node)))
            dep = loop.value
        return dep

    def launch(self) -> Tuple[tuple, List[int]]:
        """Run the built program: (copies of the outputs, the body runs of
        each loop). The hand kernels' launches are counted from the runs;
        the set-condition launches are the device's own count, which must
        agree with the body runs."""
        outs, runs, sets = self._execute()
        self._account(runs, sets)
        return outs, runs

    def _account(self, runs: List[int], sets: int) -> None:
        """Check a run's set-condition launches against its body runs and
        count the launches its pieces made."""
        if sets != self.condition_sets(runs):
            raise RuntimeError(f"device program: {sets} set-condition "
                               f"launches for body runs {runs}")
        each = self.piece_runs(runs)
        for p in self.pieces:
            CK.count_runs(self._captured[id(p)][1], each.get(id(p), 0))
        CK.count_graphs(launches=1, body_runs=sum(runs),
                        condition_sets=sets)

    def _launch(self, keep_gil: bool = False) -> None:
        """Launch on the current stream (the caller holds the card's lock).
        ``keep_gil``: keep the interpreter lock through the call
        (``enqueue``'s launches: an enumeration wave's, which were measured
        to return at once); else it is given up, as for any call that can
        block (a full launch queue, a profiler attached)."""
        from .._build import held, load

        lib = held() if keep_gil else load()
        _raise("launch", lib.gp_launch(self._exec, self.device.index,
                                       CK._stream(self.device)))

    def _execute(self) -> Tuple[tuple, List[int], int]:
        """One launch on the current stream and one host sync: (copies of
        the outputs, the body runs of each loop, the set-condition
        launches)."""
        lock = _card_lock(self.device)
        with span("programs.run", key="run_seconds", add=_add_graphs):
            with span("programs.lock_wait"):
                lock.acquire()
            try:
                self.counters.zero_()
                self._launch()
                outs = tuple(o.clone() for o in self.outputs)
                counts = self.counters.to("cpu", non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
            finally:
                lock.release()
        counts = counts.tolist()
        return outs, counts[:-1], counts[-1]

    def enqueue(self, into: List[torch.Tensor]) -> None:
        """One launch on the current stream with no host sync (the counters
        zeroed by the load before it): the outputs, each as one dimension,
        then the counters are copied into ``into``, in one call queued
        behind the launch. The card's lock is held for the launch and the
        copies alone; the caller syncs, then checks the counters with
        ``account``."""
        srcs = [self._flat(o) for o in self.outputs] + [self.counters]
        lock = _card_lock(self.device)
        with span("programs.run", key="run_seconds", add=_add_graphs):
            with span("programs.lock_wait"):
                lock.acquire()
            try:
                self._launch(keep_gil=True)
                torch._foreach_copy_(into, srcs)
            finally:
                lock.release()

    def account(self, counts: List[int]) -> None:
        """``launch``'s check and count, for an ``enqueue``'d launch whose
        counters (``counts``: the body runs of each loop, then the
        set-condition launches) have reached the host."""
        self._account(counts[:-1], counts[-1])

    def free(self) -> None:
        """Destroy the instantiated program and drop what it holds (a
        launch has ended when ``launch`` returns: it syncs)."""
        if self._exec is None and self._graph is None:
            return
        from .._build import load

        with _card_lock(self.device):
            err = load().gp_destroy(self._exec, self._graph)
        self._exec = self._graph = None
        self._captured.clear()
        self._kept = []
        _raise("destroy", err)

    def __del__(self):
        if not sys.is_finalizing() and (self._exec or self._graph):
            try:
                self.free()
            except RuntimeError:
                pass        # a card already torn down: nothing to return


def _read_flag(t: torch.Tensor) -> bool:
    """The plain executor's host read of a loop flag."""
    CK.count_graphs(flag_reads=1)
    if t.device.type != "cuda":
        return bool(t)
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return bool(host)


# ---------------------------------------------------------------------------
# groups: one program per shard, meeting at exchanges
# ---------------------------------------------------------------------------

class Exchange(NamedTuple):
    """A point where the shards of a group meet (the JAX package's psum
    over the "reads" axis): shard ``shard``'s partials ``parts`` (an f64
    and an int64 1-D tensor on its device, either None) are summed over
    the shards in shard order into its ``totals`` (``cuda_exchange``)."""

    name: str
    box: object                 # cuda_exchange.ShardExchange
    shard: int
    parts: tuple
    totals: tuple


def _launch_exchange(x: Exchange) -> None:
    """The shard's side of an exchange: one kernel launch."""
    from .cuda_exchange import exchange

    exchange(x.box, x.shard, *x.parts, *x.totals)


def _as_pieces(nodes, made: Dict[int, Piece]) -> tuple:
    """``nodes`` with each Exchange replaced by its piece (one piece for an
    Exchange that stands in several places; ``made`` keeps them by the
    Exchange's id)."""
    out = []
    for n in nodes:
        if isinstance(n, Exchange):
            n = made.setdefault(id(n), Piece(n.name, functools.partial(
                _launch_exchange, n)))
        elif isinstance(n, While):
            n = While(n.flag, _as_pieces(n.body, made))
        out.append(n)
    return tuple(out)


class Group:
    """One description over the shards of ``box`` (a
    ``cuda_exchange.ShardExchange``): ``shards[s]`` = (inputs, nodes,
    outputs) of shard s, the same structure on every shard, each piece
    touching only its shard's device, Exchange nodes where they meet.
    Inputs named in ``rows`` are cut by rows (``bounds``), the others go to
    every shard whole.

    On CUDA it is one ``Program`` per shard, each on its shard's device
    (CUDA wants a conditional node's body on one device), the exchanges
    kernel launches inside their pieces; a launch starts every shard's
    program, each on a stream of its own, before any host sync, under the
    lock of each card taken in device order, and syncs once. Every shard
    holds bit-identical exchanged sums, so every shard's loops turn as
    often; the shards' body runs, set-condition launches and barrier turns
    (counted on the device) are checked against each other. The plain
    executor walks the description stage by stage: a piece for shard 0 ...
    n-1, an exchange once every shard has reached it (on the CPU the plain
    sum, ``sum_in_order``; on a card the kernel, each shard on its stream),
    a loop's flag (shard 0's) read on the host once a turn."""

    def __init__(self, box, shards, rows=(), bounds=None):
        self.box = box
        self.devices = list(box.devices)
        self.nodes = [tuple(nodes) for _, nodes, _ in shards]
        self.rows = tuple(rows)
        self.bounds = bounds
        self.progs, self._exchanges = [], []
        for dev, (inputs, nodes, outputs) in zip(self.devices, shards):
            made: Dict[int, Piece] = {}
            self.progs.append(Program(dev, inputs, _as_pieces(nodes, made),
                                      outputs))
            self._exchanges.append({id(p) for p in made.values()})
        self.flag_reads = 0
        self.streams = ([torch.cuda.Stream(d) for d in self.devices]
                        if box.cuda else None)

    @property
    def outputs(self) -> list:
        return [p.outputs for p in self.progs]

    def load(self, values: Dict[str, object]) -> None:
        for s, prog in enumerate(self.progs):
            r0, r1 = (self.bounds[s], self.bounds[s + 1]) \
                if self.bounds is not None else (None, None)
            prog.load({k: (v[r0:r1] if k in self.rows else v)
                       for k, v in values.items()})

    def _on(self, s: int):
        if self.streams is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.streams[s])

    def _stage(self, col) -> None:
        """One node of every shard: a piece each, or an exchange."""
        if isinstance(col[0], Piece):
            for s, node in enumerate(col):
                with self._on(s):
                    node.fn()
        elif self.box.cuda:
            for s, node in enumerate(col):
                with self._on(s):
                    _launch_exchange(node)
        else:
            from .cuda_exchange import sum_in_order

            for k in range(2):
                if col[0].parts[k] is None:
                    continue
                parts = [node.parts[k] for node in col]
                for node in col:
                    node.totals[k].copy_(sum_in_order(parts,
                                                      node.totals[k].device))

    def _fork(self) -> None:
        """Each shard's stream waits for what its device's current stream
        has queued (the inputs)."""
        if self.streams is not None:
            for st, dev in zip(self.streams, self.devices):
                st.wait_stream(torch.cuda.current_stream(dev))

    def _join(self) -> None:
        if self.streams is not None:
            for st, dev in zip(self.streams, self.devices):
                torch.cuda.current_stream(dev).wait_stream(st)

    def run_plain(self) -> List[int]:
        runs = [0] * len(self.progs[0].loops)
        self.flag_reads = 0
        self._fork()
        self._walk(self.nodes, runs)
        self._join()
        return runs

    def _walk(self, cols, runs) -> None:
        for col in zip(*cols):
            if not isinstance(col[0], While):
                self._stage(col)
                continue
            i = self._index(col[0])
            while self._read(col[0].flag):
                self._walk([n.body for n in col], runs)
                runs[i] += 1

    def _index(self, loop: While) -> int:
        return next(k for k, lp in enumerate(_loops(self.nodes[0]))
                    if lp is loop)

    def _read(self, flag: torch.Tensor) -> bool:
        self.flag_reads += 1
        with self._on(0):
            return _read_flag(flag)

    def _warm(self, cols) -> None:
        """Every piece and exchange once, stage by stage (a loop's body
        once, whatever its flag)."""
        for col in zip(*cols):
            if isinstance(col[0], While):
                self._warm([n.body for n in col])
            else:
                self._stage(col)

    def build(self) -> dict:
        with span("programs.warm_up", timed=True) as warm:
            self._fork()
            with CK.recording():        # the warm-up's launches: not counted
                self._warm(self.nodes)
            for st in self.streams:
                st.synchronize()
        took = [p.compile(warm.seconds if s == 0 else 0.0)
                for s, p in enumerate(self.progs)]
        return {k: sum(t[k] for t in took) for k in took[0]}

    def turns(self, s: int, runs: List[int]) -> int:
        """Exchanges shard ``s``'s program makes in a run with these body
        runs."""
        each = self.progs[s].piece_runs(runs)
        return sum(each.get(x, 0) for x in self._exchanges[s])

    def launch(self) -> Tuple[list, List[int]]:
        """Run every shard's program: (each shard's copies of its outputs,
        the body runs of each loop)."""
        outs, counts = self._execute()
        runs = [c[:-2] for c in counts]
        if any(r != runs[0] for r in runs):
            raise RuntimeError(f"device programs of a group: the shards' "
                               f"loops turned differently: {runs}")
        turns = 0
        for s, (prog, c, r) in enumerate(zip(self.progs, counts, runs)):
            if c[-1] != self.turns(s, r):
                raise RuntimeError(f"device programs of a group: {c[-1]} "
                                   f"barrier turns for body runs {r}")
            prog._account(r, c[-2])
            turns += c[-1]
        CK.count_groups(launches=1, barrier_turns=turns)
        return outs, runs[0]

    def _execute(self):
        """Every shard's program launched on its stream, then one host
        sync: (each shard's output copies, each shard's counters: body runs
        of each loop, set-condition launches, barrier turns)."""
        from .._build import load

        lib = load()
        with span("programs.run", key="run_seconds", add=_add_graphs), \
                contextlib.ExitStack() as locks:
            with span("programs.lock_wait"):
                for index in sorted({d.index for d in self.devices}):
                    locks.enter_context(
                        _card_lock(torch.device("cuda", index)))
            self._fork()
            for s, prog in enumerate(self.progs):
                with self._on(s):
                    prog.counters.zero_()
                    self.box.state[s][1].zero_()
                    _raise("launch", lib.gp_launch(
                        prog._exec, prog.device.index,
                        self.streams[s].cuda_stream))
            outs, counts, done = [], [], []
            for s, prog in enumerate(self.progs):
                with self._on(s):
                    outs.append(tuple(o.clone() for o in prog.outputs))
                    counts.append(torch.cat([
                        prog.counters, self.box.state[s][1:]]).to(
                            "cpu", non_blocking=True))
                    ev = torch.cuda.Event()
                    ev.record()
                    done.append(ev)
            for ev in done:
                ev.synchronize()
        self._join()
        return outs, [c.tolist() for c in counts]

    def free(self) -> None:
        for prog in self.progs:
            prog.free()


# ---------------------------------------------------------------------------
# the cache of built programs
# ---------------------------------------------------------------------------

class _Slot:
    """A shape's place in the cache: its program (None until built, and
    after it is freed), the device bytes it holds, when it was last used,
    and the lock a call holds while it uses the program."""

    def __init__(self, device: torch.device):
        self.lock = threading.Lock()
        self.device = device
        self.prog: Optional[Program] = None
        self.held = 0
        self.used = 0
        # launches of the program not yet synced (``Launches``): it is not
        # freed while any is in flight
        self.pending = 0

    def free(self) -> int:
        """Free the program (the caller holds ``lock``); 1 if there was
        one."""
        prog, self.prog, self.held = self.prog, None, 0
        if prog is None:
            return 0
        prog.free()
        return 1


_CACHE: Dict[tuple, _Slot] = {}
_cache_lock = threading.Lock()
_clock = itertools.count(1)


def _key_of(kind: tuple, devices: List[torch.device], values: dict) -> tuple:
    shapes = tuple((k, tuple(v.shape), str(v.dtype)) if hasattr(v, "shape")
                   else (k, type(v).__name__) for k, v in
                   sorted(values.items()))
    return kind + tuple((d.type, d.index) for d in devices) + shapes


def _device_program(device: torch.device, capture: bool) -> bool:
    """Whether a program runs as a device program (else plainly)."""
    return device.type == "cuda" and ENABLED and capture


def _allocated(devices: List[torch.device]) -> int:
    """Device bytes the caching allocator has handed out on ``devices``'
    cards (0 on the CPU). No device sync: another thread may be
    capturing."""
    return sum(torch.cuda.memory_allocated(index) for index in
               {d.index for d in devices if d.type == "cuda"})


def _budget() -> int:
    """Device bytes the cached programs of one card may hold: the bucket
    budget, which leaves the rest of the card to the bucket in flight."""
    from .batch_driver import BUCKET_MAX_BYTES
    return BUCKET_MAX_BYTES


def _device_of(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def run(kind: tuple, device, make: Callable[[], object],
        values: Dict[str, object], capture: bool = True):
    """Run the program that ``make`` describes on ``values``: on a CUDA
    device (with ``ENABLED`` and ``capture``) the cached device program of
    this shape (built at its first call), else the plain executor on a
    program made for this call. ``kind`` names the program and what else
    its description depends on; the device and the shapes and types of
    ``values`` complete the key. Returns the outputs (copies of the
    program's buffers). ``device`` may be a list, the shards of a
    ``Group`` that ``make`` returns: the key holds them all, the group
    counts against the budget of its first device's card, and the outputs
    are a list, each shard's."""
    group = isinstance(device, (list, tuple))
    devices = [_device_of(d) for d in (device if group else [device])]
    device = devices[0]
    if not _device_program(device, capture):
        prog = make()
        prog.load(values)
        prog.run_plain()
        return prog.outputs
    with _held(_key_of(kind, devices, values), devices, make,
               values) as (slot, _):
        out = slot.prog.launch()[0]
    _trim(slot)
    return out


@contextlib.contextmanager
def _held(key: tuple, devices: List[torch.device], make, values,
          zero: bool = False):
    """(The cache's slot of ``key``, its lock held, its program built (by
    ``make``, at the first call of the key) and loaded with ``values``
    (``zero``: its counters zeroed too, ``Program.load``); whether it was
    built now)."""
    while True:
        with _cache_lock:
            slot = _CACHE.setdefault(key, _Slot(devices[0]))
        with slot.lock:
            with _cache_lock:
                if _CACHE.get(key) is not slot:
                    continue        # freed while this call waited
            built = slot.prog is None
            if built:
                before = _allocated(devices)
                prog = make()
                _load(prog, values, zero)
                took = prog.build()
                slot.prog = prog
                slot.held = max(0, _allocated(devices) - before)
                CK.count_graphs(builds=1, bytes_held=slot.held, **took)
                with _cache_lock:
                    BUILDS.append({"key": repr(key), "bytes_held": slot.held,
                                   **took})
            else:
                _load(slot.prog, values, zero)
            slot.used = next(_clock)
            yield slot, built
            return


def _load(prog, values, zero: bool) -> None:
    """``prog.load(values)``, with its counters zeroed in the same call
    where ``zero`` (a ``Program`` of ``Launches``; a ``Group``'s load takes
    no such argument)."""
    if zero:
        prog.load(values, zero=True)
    else:
        prog.load(values)


class Launches:
    """Device programs launched one after another on one card with one
    host sync for all of them: the counterpart, for many small programs, of
    the JAX package's dispatch of compiled programs without a read between
    them. ``run`` launches a program as ``graphs.run`` would, with no sync:
    the load zeroes its counters, and the launch is followed, queued, by one
    copy of its outputs into the caller's tensors ``into`` and of its
    counters into a row of this object's. ``read`` brings the tensors the
    caller names and every row to the host in one copy and syncs once,
    under the card's lock, as a launch's own sync is; then each launch's
    set-condition census is checked and its hand-kernel launches counted
    (``Program.account``), raising as a launch does on a mismatch. A
    program with a launch in flight is not freed (``_Slot.pending``). On
    the plain executor (the CPU, or ``ENABLED`` off) ``run`` runs the
    program plainly, as ``graphs.run`` does, and copies its outputs into
    ``into``; ``read`` only copies. Use as a context manager: leaving it
    syncs what is still in flight."""

    # rows of counters made at once
    ROWS = 64

    def __init__(self, device):
        self.device = _device_of(device)
        # (slot, program, where its row starts among the blocks' counts,
        # the row's width) of each launch in flight
        self._pending: List[tuple] = []
        self._blocks: List[torch.Tensor] = []    # int64 [ROWS, width] each
        self._rows: List[torch.Tensor] = []      # the last block's free rows
        self._at = 0                              # where its first starts

    def run(self, kind: tuple, make: Callable[[], "Program"],
            values: Dict[str, object], into: List[torch.Tensor],
            key: Optional[tuple] = None, capture: bool = True) -> None:
        """Launch the program of ``kind`` that ``make`` describes on
        ``values``; its outputs, each as one dimension, are copied into
        ``into``. ``key``: the program's shapes, where the values' own do
        not name them (else they do, as in ``graphs.run``)."""
        if not _device_program(self.device, capture):
            prog = make()
            prog.load(values)
            prog.run_plain()
            torch._foreach_copy_(into, [prog._flat(o) for o in prog.outputs])
            return
        devices = [self.device]
        key = (_key_of(kind, devices, values) if key is None else
               kind + tuple((d.type, d.index) for d in devices) + key)
        with _held(key, devices, make, values, zero=True) as (slot, built):
            width = slot.prog.counters.numel()
            row, at = self._row(width)
            slot.prog.enqueue(list(into) + [row])
            slot.pending += 1
            self._pending.append((slot, slot.prog, at, width))
        if built:                       # the programs held grew
            _trim(slot)

    def _row(self, width: int) -> Tuple[torch.Tensor, int]:
        """A free row of counters of ``width``, from blocks of ROWS, and
        where it starts among the blocks' counts."""
        if not self._rows or self._rows[0].numel() != width:
            self._at = sum(b.numel() for b in self._blocks)
            self._blocks.append(torch.empty((self.ROWS, width),
                                            dtype=torch.int64,
                                            device=self.device))
            self._rows = list(self._blocks[-1].unbind(0))
        at = self._at + (self.ROWS - len(self._rows)) * width
        return self._rows.pop(0), at

    def read(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """``tensors`` (float64, on this device) on the host, flattened and
        concatenated, in one copy and one sync; then every launch's
        census, checked."""
        flat = [t.reshape(-1) for t in tensors]
        n = sum(t.numel() for t in flat)
        if self.device.type != "cuda" or not self._pending:
            return torch.cat(flat).cpu() if flat else torch.zeros(0)
        flat += [b.view(-1).view(torch.float64) for b in self._blocks]
        host = torch.empty(sum(t.numel() for t in flat), dtype=torch.float64,
                           pin_memory=True)
        with span("programs.run", key="run_seconds", add=_add_graphs):
            with _card_lock(self.device):
                host.copy_(torch.cat(flat), non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
        counts = host[n:].view(torch.int64).tolist()
        pending, self._pending = self._pending, []
        self._blocks, self._rows = [], []
        try:
            for _, prog, at, width in pending:
                prog.account(counts[at:at + width])
        finally:
            _settle(pending)
        return host[:n]

    def __enter__(self) -> "Launches":
        return self

    def __exit__(self, *exc) -> None:
        pending, self._pending = self._pending, []
        self._blocks, self._rows = [], []
        if pending:
            with _card_lock(self.device):
                torch.cuda.current_stream(self.device).synchronize()
            _settle(pending)


def _settle(pending: List[tuple]) -> None:
    """The launches of ``pending`` have ended: their programs may be
    freed again."""
    for slot, *_ in pending:
        with slot.lock:
            slot.pending -= 1


def _trim(keep: _Slot) -> None:
    """Free the programs of ``keep``'s card used least recently, other than
    ``keep``'s and those in use, while the card's programs hold more than
    the budget."""
    with _cache_lock:
        mine = sorted(((k, s) for k, s in _CACHE.items()
                       if s.device == keep.device), key=lambda ks: ks[1].used)
    total = sum(s.held for _, s in mine)
    budget = _budget()
    for key, slot in mine:
        if total <= budget:
            return
        if slot is keep or not slot.lock.acquire(blocking=False):
            continue
        try:
            if slot.pending:
                continue
            with _cache_lock:
                if _CACHE.get(key) is slot:
                    del _CACHE[key]
            total -= slot.held
            CK.count_graphs(evicted=slot.free())
        finally:
            slot.lock.release()


def free_all() -> int:
    """Free every cached program (the end of a run, as a new run would
    compile anew), each once its call in flight has ended; returns how
    many."""
    with _cache_lock:
        slots = list(_CACHE.values())
        _CACHE.clear()
    n = 0
    for slot in slots:
        with slot.lock:
            n += slot.free()
    return n


def free_where(pred: Callable[[tuple], bool]) -> int:
    """Free the cached programs whose key satisfies ``pred``, each once its
    call in flight has ended; returns how many."""
    with _cache_lock:
        slots = [_CACHE.pop(k) for k in list(_CACHE) if pred(k)]
    n = 0
    for slot in slots:
        with slot.lock:
            n += slot.free()
    return n


def cached() -> int:
    """How many programs the cache holds."""
    with _cache_lock:
        return sum(s.prog is not None for s in _CACHE.values())


def reset_builds() -> None:
    with _cache_lock:
        BUILDS.clear()
