"""The preset golden workloads, for the port's tests and its smoke run.

The JAX package's golden tests (``tests/test_golden_presets.py``) simulate
one small BAM per preset from a fixed seed and freeze the caller's output
under ``tests/golden/preset_*``. This module rebuilds those inputs with the
same seeds and calls (through ``utils/simulate.py``) and reads the frozen
outputs back, so that the port can be held to them on the CPU and on a card
without importing that test module, which imports the JAX caller.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..config import CallerConfig, preset
from ..io.bam import BamFile
from .simulate import make_reference, plant_snps, simulate_bam

# tests/golden/ beside the package, in a checkout of the repository
GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "golden")

GOLDEN_NAMES = ("ont-cdna", "ont-drna", "hifi-isoseq", "exon_only")
_GOLDEN_SEEDS = {"ont-cdna": 101, "ont-drna": 102, "hifi-isoseq": 103,
                 "exon_only": 104}
_EXON_GTF = ('chrS\tsrc\tgene\t1\t6000\t.\t+\t.\tgene_id "G1";\n'
             'chrS\tsrc\tCDS\t400\t2600\t.\t+\t.\tgene_id "G1";\n'
             'chrS\tsrc\tCDS\t3200\t5400\t.\t+\t.\tgene_id "G1";\n')


def golden_workload(name: str, tmp: str
                    ) -> Tuple[str, str, CallerConfig, Optional[str]]:
    """One simulated workload of tests/test_golden_presets.py, rebuilt with
    the same seeds and calls. Returns (bam, fasta, cfg, annotation or
    None)."""
    rng = np.random.default_rng(_GOLDEN_SEEDS[name])
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=10, n_hom=2, min_gap=400)
    bam = os.path.join(tmp, f"{name}.bam")
    if name == "exon_only":
        simulate_bam(bam, rng, ref, truth, n_reads=90, read_len=2500,
                     err_rate=0.01)
        anno = os.path.join(tmp, "exon.gtf")
        with open(anno, "w") as f:
            f.write(_EXON_GTF)
        return (bam, bam[:-4] + ".fa",
                preset("hifi-masseq").replace(threads=2, exon_only=True),
                anno)
    # a single-strand artifact site away from the planted SNPs
    planted = sorted(set(truth.het_snps) | set(truth.hom_snps))
    site = 4400
    while any(abs(site - q) < 150 for q in planted):
        site += 37
    alt = int(b"ACGT"[(b"ACGT".index(bytes([int(ref[site])])) + 2) % 4])
    simulate_bam(bam, rng, ref, truth, n_reads=90, read_len=2500,
                 err_rate=0.01, biased_sites={site: alt})
    return bam, bam[:-4] + ".fa", preset(name).replace(threads=2), None


def records_and_tags(vcf_path: str, bam_path: str
                     ) -> Tuple[List[str], List[str]]:
    """(VCF record lines, sorted "qname HP PS" lines of the phased BAM)."""
    with open(vcf_path) as f:
        records = [l for l in f if not l.startswith("#")]
    rows = []
    pb = BamFile(bam_path)
    for i in range(pb.n_records):
        r = pb.read(i)
        hp = r.get_tag("HP")
        if hp is not None:
            rows.append(f"{r.qname}\t{hp}\t{r.get_tag('PS')}\n")
    rows.sort()
    return records, rows


def golden(tag: str) -> Tuple[List[str], List[str]]:
    """The frozen (records, tags) of tests/golden/preset_<tag>_*."""
    base = os.path.join(GOLDEN_DIR, f"preset_{tag}")
    with open(base + "_records.vcf") as f:
        recs = f.readlines()
    with open(base + "_tags.tsv") as f:
        tags = f.readlines()
    return recs, tags
