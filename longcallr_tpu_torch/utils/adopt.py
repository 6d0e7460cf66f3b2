"""Carry host state of the JAX package over into the port's own types.

The port keeps its own copies of ``CallerConfig``, ``Region`` and
``PileupTensors`` (config.py, tiles/regions.py, tiles/pileup.py). A test
that compares the two packages builds an object with one and hands it to
the other's function; ``adopt`` rebuilds such an object as the port's type
of the same name, field by field (numpy arrays are shared, not copied). The
device side has its own carriers: ``CompactCells.from_numpy`` and
``PhaseState.from_numpy`` turn numpy arrays into tensors on a device.

Nothing of the JAX package is imported here: the source object is read
through ``dataclasses.fields`` and matched by its class name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from ..config import CallerConfig
from ..tiles.pileup import PileupTensors
from ..tiles.regions import Region

_TYPES = {c.__name__: c for c in (CallerConfig, Region, PileupTensors)}


def adopt(obj: Any) -> Any:
    """``obj`` as the port's dataclass of the same class name (nested
    dataclass fields, such as a pileup's region, are adopted too). Raises
    ``TypeError`` for a type the port has no copy of, and for a source whose
    fields differ from the port's."""
    cls = _TYPES.get(type(obj).__name__)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no port type for {type(obj).__name__}")
    if isinstance(obj, cls):
        return obj
    names = [f.name for f in dataclasses.fields(obj)]
    if names != [f.name for f in dataclasses.fields(cls)]:
        raise TypeError(f"{type(obj).__name__}: fields differ from the "
                        f"port's copy")
    kw = {}
    for n in names:
        v = getattr(obj, n)
        if dataclasses.is_dataclass(v) and type(v).__name__ in _TYPES:
            v = adopt(v)
        kw[n] = v
    return cls(**kw)
