"""What the harness and the reference load: never JAX or the JAX package,
and the reference nothing of the program."""

import json
import subprocess
import sys

from conftest import PERFBENCH, ROOT

HARNESS = ["harness.bamio", "harness.cell", "harness.check", "harness.manifest",
           "harness.rss", "harness.trace"]
REFERENCE = ["reference.pipeline", "reference.regions", "reference.runner",
             "reference.config", "reference.rng"]


def _top_level_after(modules):
    code = (f"import sys; sys.path[:0] = [{PERFBENCH!r}, {ROOT!r}]\n"
            f"import importlib, json\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _top_level_after(HARNESS)
    assert not top & {"jax", "jaxlib", "flax", "longcallr_tpu"}


def test_reference_loads_nothing_of_the_program():
    top = _top_level_after(REFERENCE)
    assert not top & {"jax", "jaxlib", "flax", "longcallr_tpu",
                      "longcallr_tpu_torch", "torch"}


def test_forbidden_modules_are_found_by_top_level_name(monkeypatch):
    from harness.cell import forbidden_modules

    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, "longcallr_tpu_torch.x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "longcallr_tpu.io", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"jax", "longcallr_tpu"} <= set(forbidden_modules())
