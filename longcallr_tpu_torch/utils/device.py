"""Compute-device resolution and size-based placement for the torch port.

Counterpart of ``longcallr_tpu/utils/device.py``. The port has no ambient
default device: the CLI's ``--platform`` flag resolves to one
``torch.device`` here (``resolve_device``) and every device stage is handed
that device.

Placement by size: a problem too small to pay for its kernel launches on
the card runs elsewhere. ``small_problem_device`` (candidate selection, in
cells) returns the device to use; ``phase_placement`` (phasing, in work
units) returns a ``Placement``, the device and whether the problem runs
member by member in float64 there. Nothing is ambient. This is routing by
size, not a fallback: neither function asks whether a card is present, and
a run whose device is the CPU gets the CPU back for every size. A phase
problem placed on the host runs the f64 path there (split mode belongs to
CUDA tensors, ``phasing/optimize.split_mode``), and an enumeration problem
on a card run the same f64 path on the card, at every size: both write the
bytes of the split path's safety net.

The thresholds are the card's own, set from
``experiments/torch_placement_sweep.py`` on an NVIDIA H100 80GB HBM3 (PERF.md
has the run). The environment variables keep the JAX package's names:
LONGCALLR_TPU_MIN_CELLS and LONGCALLR_TPU_MIN_PHASE_WORK (0 places
everything else on the run's device in its own mode; a huge value puts
every candidate call and every iterative phase problem on the host).
LONGCALLR_TPU_MIN_PHASE_WORK no longer moves a card run's enumeration
problems, which run in float64 on the card whatever it says, but where
split mode is forced (LONGCALLR_F32_KERNELS=1): they then route by it as
before, the split bucket path at and above it.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import NamedTuple, Optional

import torch

log = logging.getLogger("longcallr_tpu_torch")

# --platform spellings of the two supported targets
_ALIASES = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}

_CPU = torch.device("cpu")

# Candidate selection: problems of fewer cells (padded columns x 16) run on
# the host. Measured crossing on an NVIDIA H100 80GB HBM3 (700 W), transfers
# included: 2^16.3 cells (at 2^16 the host takes 4.3 ms and the card 5.0, at
# 2^18 9.8 and 4.9).
MIN_ACCEL_CELLS = int(os.environ.get("LONGCALLR_TPU_MIN_CELLS",
                                     str(1 << 16)))

# Phase-stage routing is by work, not by cells: the ascent schedule costs
# about (rounds x iterations) passes over the cell matrix. Work unit: cells
# x rounds, B·K·I_pad·(I//4+1) for the iterative path and B·2^I·K·I_pad for
# the enumeration path (the per-config ascents play the rounds' part).
# An enumeration problem of a card run runs in float64 on the card at every
# size. Measured on the same card, one region at a time
# (experiments/torch_placement_sweep.py; PERF.md has the runs): an
# enumeration region takes 2.2 ms in float64 on the card at work 2^13 and
# 15.6 ms at 2^23, against 4.8, 14.8 and 473 ms on the host at 2^13, 2^18
# and 2^23 and 7.6-39 ms in split mode with its float64 recompute (which
# crosses the host at 2^16.3); with 8 other threads preparing regions, as
# the pipeline's pool does, the host takes 490-995 ms and the card's
# float64 route 58-87 ms. So the card's float64 route wins at every
# measured size, busy or idle. An iterative problem at or above the
# threshold runs on the run's device in its mode (split on a card, with the
# safety net), below it on the host. The threshold itself is the split
# route's crossing measured before the device programs (2^18.7-2^19.1):
# buckets of B regions cost the card about what one region does and the
# host B times as much. An iterative region crossed only at 2^24 then (37 ms at 2^14,
# 181 at 2^23, against the host's 16 and 140); with the device programs
# the card won at every measured size (13.9 ms against 22.6 at 2^14), but
# no benchmark cell runs iterative regions, so they keep the host below
# the threshold until one measures them.
MIN_ACCEL_PHASE_WORK = int(os.environ.get("LONGCALLR_TPU_MIN_PHASE_WORK",
                                          str(1 << 19)))


class Placement(NamedTuple):
    """Where the router put a phase problem: ``device``, and ``f64``: True
    where the problem runs on the per-region float64 path there, in the
    mode a host placement runs (a card run's enumeration problem)."""

    device: torch.device
    f64: bool = False


# Phase problems (regions of the per-region loop, buckets of the batched
# pipeline) by where the router placed them: on the host, on the card in
# its own mode, on the card in float64; caller.py copies the differences
# over a run into CallerOutputs.stage_seconds (phase_host_placed /
# phase_card_placed / phase_card_f64_placed).
PLACEMENTS = {"host": 0, "card": 0, "card_f64": 0}

# Phase problems at or above the threshold that ran on the host because the
# run's device is the CPU. Counted, and warned of once per process, so that
# a run that was meant for a card and got none of it is visible (caller.py
# copies the count into CallerOutputs.n_degraded_placements).
DEGRADED_PLACEMENTS = 0
_lock = threading.Lock()
_warned_degraded = False


def resolve_device(platform: Optional[str] = "cuda") -> torch.device:
    """Map a ``--platform`` value to a ``torch.device``. ``None`` means
    ``cuda``. Raises when CUDA is asked for and absent (no CPU
    continuation) and for any other platform name."""
    name = _ALIASES.get((platform or "cuda").lower())
    if name is None:
        raise ValueError(f"unsupported platform {platform!r} "
                         f"(choose one of {sorted(_ALIASES)})")
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("platform 'cuda' was requested but no CUDA "
                               "device is available")
        # f32 contractions keep full precision (the split-Dp matvecs are
        # hand kernels, but any torch matmul must not drop to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return torch.device("cuda", torch.cuda.current_device())
    return _CPU


def small_problem_device(n_cells: int, device: torch.device) -> torch.device:
    """The host for a problem below MIN_ACCEL_CELLS, else ``device``."""
    return device if n_cells >= MIN_ACCEL_CELLS else _CPU


def _split_forced() -> bool:
    """Whether LONGCALLR_F32_KERNELS=1 forces split mode (the switch is the
    phase's, ``phasing/optimize.USE_F32_KERNELS``)."""
    from ..phasing import optimize
    return optimize.USE_F32_KERNELS is True


def phase_placement(work: int, device: torch.device,
                    enumeration: bool = False) -> Placement:
    """Where a phase problem of ``work`` (cells x rounds) runs. On a card
    run an ``enumeration`` problem runs in float64 on the card at every
    size (where split mode is forced, below MIN_ACCEL_PHASE_WORK only);
    any other problem at or above MIN_ACCEL_PHASE_WORK on ``device`` in its
    own mode, below it on the host. A CPU run gets the CPU at every size.
    One call per problem: it counts the placement, and a problem of card
    size on a CPU run as degraded."""
    global DEGRADED_PLACEMENTS, _warned_degraded
    wants_card = work >= MIN_ACCEL_PHASE_WORK
    if enumeration and device.type == "cuda" and not (
            wants_card and _split_forced()):
        placed = Placement(device, f64=True)
    elif wants_card or device.type == "cpu":
        placed = Placement(device)
    else:
        placed = Placement(_CPU)
    where = ("card_f64" if placed.f64 else
             "card" if placed.device.type == "cuda" else "host")
    warn = False
    with _lock:
        PLACEMENTS[where] += 1
        if wants_card and placed.device.type == "cpu":
            DEGRADED_PLACEMENTS += 1
            warn, _warned_degraded = not _warned_degraded, True
    if warn:
        log.warning(
            "a phase problem of card size (work=%d >= %d) is running on the "
            "host because this run's device is the CPU", work,
            MIN_ACCEL_PHASE_WORK)
    return placed
