"""The torch port stands alone: it runs with ``jax`` and ``longcallr_tpu``
unimportable, and no file of it names either in an import.

The first test runs in a subprocess whose import machinery refuses both
names. Every module of ``longcallr_tpu_torch`` is imported there, then the
CLI calls a small simulated BAM on the CPU and lists its regions
(``--get-blocks``), both to exit code 0.
"""

import os
import pkgutil
import re
import subprocess
import sys

import longcallr_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "longcallr_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} is refused in this test")
        return None


sys.meta_path.insert(0, Refuse())
for name in BLOCKED:
    try:
        importlib.import_module(name)
    except ImportError:
        continue
    raise SystemExit(f"{name} was importable")

import longcallr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(longcallr_tpu_torch.__path__,
                                               "longcallr_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("IMPORTED", len(names))

import numpy as np
from longcallr_tpu_torch import cli
from longcallr_tpu_torch.utils.simulate import (make_reference, plant_snps,
                                                simulate_bam)

tmp = sys.argv[1]
rng = np.random.default_rng(31)
ref = make_reference(rng, 9000)
truth = plant_snps(rng, ref, n_het=10, n_hom=2, min_gap=400)
bam = tmp + "/in.bam"
simulate_bam(bam, rng, ref, truth, n_reads=80, read_len=2500, err_rate=0.01)
base = ["-b", bam, "-f", tmp + "/in.fa", "-o", tmp + "/out", "-p",
        "hifi-masseq"]
rc = cli.main(base + ["--platform", "cpu", "--index-output"])
assert rc == 0 and cli.LAST_RUN.n_records > 0, rc
rc = cli.main(base + ["--get-blocks"])
assert rc == 0, rc
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("RAN", cli.LAST_RUN.n_records)
"""


def test_port_runs_with_jax_and_the_jax_package_blocked(tmp_path):
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "IMPORTED" in res.stdout and "RAN" in res.stdout
    n_modules = len(list(pkgutil.walk_packages(
        longcallr_tpu_torch.__path__, "longcallr_tpu_torch.")))
    assert f"IMPORTED {n_modules}" in res.stdout and n_modules >= 30
    assert "chrS:" in res.stdout                      # --get-blocks
    assert os.path.exists(tmp_path / "out.vcf")
    assert os.path.exists(tmp_path / "out.phased.bam.bai")


_IMPORT = re.compile(
    r"^\s*(from|import)\s+(jax|jaxlib|longcallr_tpu)(\.|\s|$)", re.M)
_DYNAMIC = re.compile(
    r"""(import_module|__import__)\(\s*['"](jax|longcallr_tpu)['".]""")


def _port_sources():
    pkg = os.path.join(REPO, "longcallr_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_imports_jax_or_the_jax_package():
    paths = list(_port_sources())
    assert len(paths) >= 30
    bad = []
    for path in paths:
        with open(path) as f:
            text = f.read()
        for rx in (_IMPORT, _DYNAMIC):
            bad += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                    for m in rx.finditer(text)]
        if path.endswith("chip_smoke.py"):
            assert "sys.path" not in text
    assert not bad, bad


def test_no_test_imports_chip_smoke():
    tests = os.path.join(REPO, "tests")
    rx = re.compile(r"^\s*(import chip_smoke|from chip_smoke)", re.M)
    bad = []
    for f in sorted(os.listdir(tests)):
        if f.endswith(".py"):
            with open(os.path.join(tests, f)) as fh:
                if rx.search(fh.read()):
                    bad.append(f)
    assert not bad, bad
