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


_POD = ["--coordinator", "localhost:{port}", "--num-processes", "1",
        "--process-id", "0"]


@pytest.mark.parametrize("flag", [["--profile-dir", "{tmp}/prof"],
                                  _POD + ["--stream", "--resume"], _POD])
def test_unported_flags_raise(tmp_path, flag):
    """The flags that once raised NotImplementedError now run on the CPU:
    --profile-dir writes a torch.profiler trace, and a 1-process pod (the
    pod flags, also with --stream --resume) writes the VCF bytes of a plain
    run."""
    import socket

    from longcallr_tpu_torch import cli
    from longcallr_tpu_torch.io.bai import build_bai

    rng = np.random.default_rng(77)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=10, n_hom=1, min_gap=400)
    bam = str(tmp_path / "f.bam")
    simulate_bam(bam, rng, ref, truth, n_reads=60, read_len=2500,
                 err_rate=0.01)
    build_bai(bam)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = ["-b", bam, "-f", str(tmp_path / "f.fa"), "-p", "hifi-masseq",
            "--platform", "cpu", "--min-read-length", "100"]
    assert cli.main(base + ["-o", str(tmp_path / "plain")]) == 0
    flag = [f.format(port=port, tmp=tmp_path) for f in flag]
    assert cli.main(base + ["-o", str(tmp_path / "x"), *flag]) == 0
    with open(tmp_path / "plain.vcf", "rb") as a, \
            open(tmp_path / "x.vcf", "rb") as b:
        assert a.read() == b.read()
    if flag[0] == "--profile-dir":
        assert any(f.endswith(".pt.trace.json")
                   for f in os.listdir(tmp_path / "prof"))
    else:
        assert not torch.distributed.is_initialized()


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


@pytest.mark.parametrize("entry", ["run", "phase_region", "select_candidates",
                                   "select_candidates_batched",
                                   "phase_regions_batched"])
def test_entry_points_ask_for_cuda_when_no_device_is_given(tmp_path, entry):
    """An entry point called without a device resolves to the CUDA device
    and raises where there is none: nothing runs on the CPU unless the
    caller asks for it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    from longcallr_tpu_torch.ops.candidates import (select_candidates,
                                                    select_candidates_batched)
    from longcallr_tpu_torch.phasing.batch_driver import phase_regions_batched
    from longcallr_tpu_torch.phasing.optimize import phase_region

    cfg = preset("hifi-masseq")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "run":
            bam, fa = _fresh_workload(tmp_path)
            run(bam, fa, str(tmp_path / "nodev"), cfg)
        elif entry == "phase_region":
            phase_region(None, None, cfg, seed=1)
        elif entry == "select_candidates":
            select_candidates(None, cfg)
        elif entry == "select_candidates_batched":
            select_candidates_batched([], cfg)
        else:
            phase_regions_batched([], cfg)
