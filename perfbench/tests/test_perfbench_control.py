"""On the card's machine: the control, the reference with the preset's
strand-bias filter switched and put in the program's place (``run.py
--control``), at each cell's own size, has to come out not correct on
every seed tried. Run there:

    python -m pytest perfbench/tests -q -m card
"""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from harness import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    for seed in SEEDS:
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
             "--workload", workload, "--seed", str(seed), "--seconds", "1",
             "--trace", "0", "--control"],
            capture_output=True, text=True, cwd=ROOT, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] is False, result["check"]
