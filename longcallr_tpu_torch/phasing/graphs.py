"""CUDA graphs of the phase programs: the port's counterpart of ``jax.jit``.

In the JAX package a bucket's whole perturbation schedule is one device
program (``jax.jit`` over a ``fori_loop`` of rounds whose ascents are
``while_loop``s), so the host issues it once. Run eagerly, the same schedule
issues about 117 small launches per ascent trip from Python, and the card
waits for them. A ``Runner`` takes the schedule's steps instead (callables
that read and write only tensors allocated before their first call, and
make no host sync) and, on a CUDA device, runs each step's first call
eagerly, captures the step once as a ``torch.cuda.CUDAGraph`` on a stream of
its own, and replays the graph at every later call. On the CPU, or where
``ENABLED`` is false, it calls the step as it is: the same tensors, the same
order of operations, the same bytes.

The host reads a step's continue flag through ``flag``: a copy into pinned
host memory behind the step, then an event it waits on.

A capture runs in the calling thread's own capture mode
(``thread_local``), under one lock per card: the rows of a regions mesh
capture in their threads while the other rows go on launching and
syncing. Each graph has its own memory pool, freed with the graph when the
runner goes (at the end of a bucket), and keeps the cols workspace it was
captured with (``cuda_kernels.take_workspaces``). The hand kernels' launch
counts are recorded at capture and added at each replay
(``cuda_kernels.count_replay``), so a run counts the same launches with
graphs as without.

There is no quiet fallback: on a CUDA device a capture or a replay that
fails raises. ``ENABLED`` is the one switch, for an A/B of graphs against
eager launches of the same steps; nothing in the port turns it off.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

import torch

from . import cuda_kernels as CK

# capture and replay the schedule's steps on CUDA devices (False: call them
# eagerly, for an A/B)
ENABLED = True

_locks: Dict[int, threading.Lock] = {}
_locks_lock = threading.Lock()


def _capture_lock(device: torch.device) -> threading.Lock:
    with _locks_lock:
        return _locks.setdefault(device.index, threading.Lock())


class Runner:
    """Runs named steps on ``device``: eagerly where graphs are off (the CPU,
    ``ENABLED`` false, or ``capture`` false), else as CUDA graphs captured
    at a step's first call and replayed after it."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        cuda = self.device.type == "cuda"
        self.graphs = cuda and capture and ENABLED
        # name → (graph, launches its capture recorded, workspace it keeps)
        self._captured: Dict[str, tuple] = {}
        self._side = torch.cuda.Stream(self.device) if self.graphs else None
        self._host = (torch.zeros((), dtype=torch.bool, pin_memory=True)
                      if cuda else None)
        self._event = torch.cuda.Event() if cuda else None

    def __call__(self, name: str, step: Callable[[], None]) -> None:
        if not self.graphs:
            step()
            return
        done = self._captured.get(name)
        if done is not None:
            done[0].replay()
            CK.count_replay(done[1])
            return
        step()                      # the first call runs eagerly
        self._capture(name, step)

    def _capture(self, name: str, step) -> None:
        t0 = time.perf_counter()
        stream = self._side.cuda_stream
        graph = torch.cuda.CUDAGraph()
        with _capture_lock(self.device), torch.cuda.stream(self._side):
            # a workspace left on this stream by eager calls is not captured
            CK.take_workspaces(self.device, stream)
            with CK.recording() as launches:
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    step()
                finally:
                    graph.capture_end()
            kept = CK.take_workspaces(self.device, stream)
        self._captured[name] = (graph, launches, kept)
        CK.count_capture(time.perf_counter() - t0)

    def flag(self, t: torch.Tensor) -> bool:
        """The value of the bool scalar ``t`` on the host, once the work
        queued before it is done."""
        if self._host is None:
            return bool(t)
        self._host.copy_(t, non_blocking=True)
        self._event.record()
        self._event.synchronize()
        return bool(self._host)
