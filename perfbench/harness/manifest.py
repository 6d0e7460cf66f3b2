"""Finds every piece of a cell by its name in ``BENCHMARK.json``: the
configuration file, the traffic file and its generator, and each per-layer
metric's reader, ``metrics/<name>.py``."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Dict, List

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)


def load(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: Dict, name: str) -> Dict:
    """The configuration's file, with its entry's name."""
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return dict(json.load(f), name=name)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    with open(os.path.join(PERFBENCH, "traffic", name + ".json")) as f:
        return json.load(f)


def _module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # known by name, so that worker processes can find its functions
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def generator(name: str) -> ModuleType:
    return _module(os.path.join(PERFBENCH, "traffic", name + ".py"),
                   "perfbench_traffic_" + name)


def metrics(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports: those whose ``workloads`` name it, or that have none."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def reader(name: str) -> ModuleType:
    return _module(os.path.join(PERFBENCH, "metrics", name + ".py"),
                   "perfbench_metric_" + name.replace(".", "_"))
