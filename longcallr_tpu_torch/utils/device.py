"""Compute-device resolution and size-based placement for the torch port.

Counterpart of ``longcallr_tpu/utils/device.py``. The port has no ambient
default device: the CLI's ``--platform`` flag resolves to one
``torch.device`` here (``resolve_device``) and every device stage is handed
that device.

Placement by size: a problem too small to pay for its kernel launches on
the card runs on the host instead. ``small_problem_device`` (candidate
selection, in cells) and ``phase_problem_device`` (phasing, in work units)
take the run's device and return the device to use; nothing is ambient.
This is routing by size, not a fallback: neither function asks whether a
card is present, and a run whose device is the CPU gets the CPU back for
every size. A problem placed on the host runs the f64 path there (split
mode belongs to CUDA tensors, ``phasing/optimize.split_mode``), which
writes the same bytes.

The thresholds are the card's own, set from
``experiments/torch_placement_sweep.py`` on an NVIDIA H100 80GB HBM3 (PERF.md
has the run). The environment variables keep the JAX package's names:
LONGCALLR_TPU_MIN_CELLS and LONGCALLR_TPU_MIN_PHASE_WORK (0 places
everything on the run's device, a huge value everything on the host).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

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
# Problems of less work run on the host. Measured on the same card, one
# region at a time: an enumeration region crosses at work 2^18.7 (the card
# takes 11-43 ms whatever the size, its f64 recompute included; the host
# 3 ms at 2^13, 10 at 2^18, 44 at 2^20, 132 at 2^23), an iterative region
# only at 2^24 (the card's time follows the rounds, 37 ms at 2^14 and 181
# at 2^23 against the host's 16 and 140). The default is the lower
# crossing: a bucket of B regions costs the card about what one region
# does and the host B times as much, so buckets cross below either; the
# price is a lone iterative region of 2^19 to 2^24 on the card, up to
# 41 ms or 2x slower than on the host.
MIN_ACCEL_PHASE_WORK = int(os.environ.get("LONGCALLR_TPU_MIN_PHASE_WORK",
                                          str(1 << 19)))

# Phase problems (regions of the per-region loop, buckets of the batched
# pipeline) by the device the router returned; caller.py copies the
# differences over a run into CallerOutputs.stage_seconds
# (phase_host_placed / phase_card_placed).
PLACEMENTS = {"host": 0, "card": 0}

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


def phase_problem_device(work: int, device: torch.device) -> torch.device:
    """The host for a phase problem below MIN_ACCEL_PHASE_WORK (work = cells
    x rounds), else ``device``. One call per problem: it counts the
    placement, and a problem of card size on a CPU run as degraded."""
    global DEGRADED_PLACEMENTS, _warned_degraded
    wants_card = work >= MIN_ACCEL_PHASE_WORK
    placed = device if wants_card else _CPU
    warn = False
    with _lock:
        PLACEMENTS["card" if placed.type == "cuda" else "host"] += 1
        if wants_card and placed.type == "cpu":
            DEGRADED_PLACEMENTS += 1
            warn, _warned_degraded = not _warned_degraded, True
    if warn:
        log.warning(
            "a phase problem of card size (work=%d >= %d) is running on the "
            "host because this run's device is the CPU", work,
            MIN_ACCEL_PHASE_WORK)
    return placed
