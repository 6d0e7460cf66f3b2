"""Tests of the benchmark: ``python -m pytest perfbench/tests -q`` from the
checkout's root. Those marked ``card`` need an NVIDIA card and skip
elsewhere: ``python -m pytest perfbench/tests -q -m card`` on the card."""

import os
import sys

import pytest

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)
for p in (ROOT, PERFBENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips where there is none)")


@pytest.fixture
def card():
    """Skips the test where this machine has no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


# small layouts of the two cells' traffic, for runs on the CPU
SMALL_TRAFFIC = {
    "transcriptome": {"generator": "transcripts", "params": {
        "n_contigs": 2, "loci_per_contig": 3, "tx_lengths": [1800, 5400, 9000],
        "coverages": [15, 60, 30, 120], "snp_spacing": 900, "read_len": 1500,
        "gap": 5000, "layout_seed": 20261018}},
    "genome-stream": {"generator": "genome", "params": {
        "contigs": [["chr1", [[8000, 40, 200]] * 2], ["chr2", [[6000, 40, 200]]]],
        "err_rate": 0.06, "qual": [12, 26], "alt_strands": True}},
}
