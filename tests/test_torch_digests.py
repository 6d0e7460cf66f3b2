"""The port's output on the bench inputs against frozen digests of the JAX
package's output (tests/golden/reference_digests.json, written by
experiments/reference_digests.py on the JAX CPU backend).

On the CPU the genome workload (``make_genome_workload`` defaults: 3
contigs, 8 loci, one 300x locus) runs through ``caller.run`` with the
hifi-masseq preset: the SHA-256 of its VCF record lines and of its sorted
HP/PS tag lines equal the reference's. The card holds its runs of the deep,
genome and stream inputs to the same file (``chip_smoke.py``). The digest
of the port (``utils/goldens.digests``) and the script's agree on one
output.
"""

import importlib.util
import os

import torch

from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.pipeline.caller import run
from longcallr_tpu_torch.utils import goldens
from longcallr_tpu_torch.utils.bench_workload import make_genome_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _script():
    spec = importlib.util.spec_from_file_location(
        "reference_digests",
        os.path.join(REPO, "experiments", "reference_digests.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_reference_digests_cover_the_bench_inputs():
    ref = goldens.reference_digests()
    for label in ("deep", "deep_one_wave", "genome"):
        assert ref[label]["ok"], label
        assert ref[label]["n_records"] > 0 and ref[label]["n_tagged"] > 0
    # the deep input's default waves and its one wave write the same
    assert {k: v for k, v in ref["deep"].items() if k != "seconds"} == \
        {k: v for k, v in ref["deep_one_wave"].items() if k != "seconds"}
    assert "stream" in ref and "seconds" in ref["stream"]


def test_genome_workload_matches_the_reference_digest(tmp_path):
    bam, fa = str(tmp_path / "genome.bam"), str(tmp_path / "genome.fa")
    make_genome_workload(bam, fa)
    out = run(bam, fa, str(tmp_path / "out"), preset("hifi-masseq"),
              device=CPU)
    assert goldens.same_as_reference("genome", out.vcf_path,
                                     out.phased_bam_path)


def test_the_digests_of_the_port_and_the_script_agree(tmp_path):
    bam, fa, cfg, anno = goldens.golden_workload("ont-cdna", str(tmp_path))
    out = run(bam, fa, str(tmp_path / "out"), cfg, anno_path=anno,
              device=CPU)
    got = goldens.digests(out.vcf_path, out.phased_bam_path)
    assert got == _script().digests(out.vcf_path, out.phased_bam_path)
    assert got["n_records"] > 0 and got["n_tagged"] > 0
