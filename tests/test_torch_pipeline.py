"""The torch port's whole per-region path on the CPU.

* ``run(device=cpu)`` on the four preset-golden workloads reproduces
  ``tests/golden/preset_*`` (the JAX package's output) byte for byte;
* on a fresh seeded workload it equals the JAX package's ``run()``;
* the CLI (``--platform cpu`` and ``--get-blocks``) in a subprocess;
* importing and running the port never loads ``jax``.

Tolerance: byte equality of VCF records and sorted HP/PS tags.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.pipeline.caller import run
from longcallr_tpu_torch.utils import goldens
from longcallr_tpu_torch.utils.simulate import (make_reference, plant_snps,
                                                simulate_bam)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", goldens.GOLDEN_NAMES)
def test_preset_golden_on_cpu(tmp_path, name):
    """The workloads of tests/test_golden_presets.py, same seeds and calls
    (built by utils/goldens.py; chip_smoke.py runs the same check on the
    card)."""
    bam, fa, cfg, anno = goldens.golden_workload(name, str(tmp_path))
    out = run(bam, fa, str(tmp_path / "out"), cfg, anno_path=anno,
              device=CPU)
    got = goldens.records_and_tags(out.vcf_path, out.phased_bam_path)
    assert got == goldens.golden(name)


def test_chip_smoke_fails_without_cuda():
    """No card: the smoke exits non-zero and prints no result line."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _fresh_workload(tmp_path):
    """Two loci (one enumeration-sized, one iterative) on one contig."""
    rng = np.random.default_rng(777)
    ref = make_reference(rng, 20000)
    truth = plant_snps(rng, ref, n_het=24, n_hom=3, min_gap=500)
    bam = str(tmp_path / "fresh.bam")
    simulate_bam(bam, rng, ref, truth, n_reads=160, read_len=3000,
                 err_rate=0.02)
    return bam, bam.replace(".bam", ".fa")


def test_run_matches_jax_run(tmp_path):
    from longcallr_tpu.config import preset as jax_preset
    from longcallr_tpu.pipeline.caller import run as jax_run

    bam, fa = _fresh_workload(tmp_path)
    cfg = preset("hifi-masseq").replace(threads=2)
    want = jax_run(bam, fa, str(tmp_path / "jax"),
                   jax_preset("hifi-masseq").replace(threads=2))
    got = run(bam, fa, str(tmp_path / "torch"), cfg, device=CPU)
    a = goldens.records_and_tags(got.vcf_path, got.phased_bam_path)
    b = goldens.records_and_tags(want.vcf_path, want.phased_bam_path)
    assert a[0] and a[1]
    assert a == b
    assert got.n_phased_sites == want.n_phased_sites > 0


def _cli(*args, **env):
    return subprocess.run(
        [sys.executable, "-m", "longcallr_tpu_torch.cli", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **env))


def test_cli_cpu_and_get_blocks(tmp_path):
    bam, fa = _fresh_workload(tmp_path)
    res = _cli("-b", bam, "-f", fa, "-o", str(tmp_path / "cli"), "-p",
               "hifi-masseq", "--platform", "cpu")
    assert res.returncode == 0, res.stderr
    assert "on cpu" in res.stdout
    out = run(bam, fa, str(tmp_path / "direct"),
              preset("hifi-masseq").replace(threads=1), device=CPU)
    assert (goldens.records_and_tags(str(tmp_path / "cli.vcf"),
                              str(tmp_path / "cli.phased.bam"))
            == goldens.records_and_tags(out.vcf_path, out.phased_bam_path))
    res = _cli("-b", bam, "-f", fa, "-o", str(tmp_path / "gb"), "-p",
               "hifi-masseq", "--get-blocks")
    assert res.returncode == 0, res.stderr
    blocks = [l for l in res.stdout.splitlines() if l.startswith("chrS:")]
    assert blocks and all(len(l.split()) == 2 for l in blocks)


def test_port_never_imports_jax(tmp_path):
    """A fresh interpreter imports the port's CLI and runs a CPU call: jax
    stays out of sys.modules."""
    bam, fa = _fresh_workload(tmp_path)
    code = (
        "import sys\n"
        "from longcallr_tpu_torch import cli\n"
        f"rc = cli.main(['-b', {bam!r}, '-f', {fa!r}, '-o', "
        f"{str(tmp_path / 'nojax')!r}, '-p', 'hifi-masseq', "
        "'--platform', 'cpu'])\n"
        "assert rc == 0 and cli.LAST_RUN.n_records > 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('NOJAX')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "NOJAX" in res.stdout


@pytest.mark.parametrize("flag", [["--batched"], ["--stream"], ["--resume"],
                                  ["--coordinator", "localhost:1",
                                   "--num-processes", "2",
                                   "--process-id", "0"]])
def test_unported_flags_raise(flag):
    from longcallr_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["-b", "x.bam", "-f", "x.fa", "-o", "x", "-p",
                  "hifi-masseq", *flag])


def test_resolve_device():
    from longcallr_tpu_torch.utils.device import resolve_device

    assert resolve_device("cpu") == CPU
    with pytest.raises(ValueError):
        resolve_device("tpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
