"""The preset golden workloads, for the port's tests and its smoke run.

The JAX package's golden tests (``tests/test_golden_presets.py``) simulate
one small BAM per preset from a fixed seed and freeze the caller's output
under ``tests/golden/preset_*``. This module rebuilds those inputs with the
same seeds and calls (through ``utils/simulate.py``) and reads the frozen
outputs back, so that the port can be held to them on the CPU and on a card
without importing that test module, which imports the JAX caller.

The bench inputs (deep, genome, stream) and the enumeration inputs
(``ENUM_INPUTS``) are held to frozen digests of the JAX package's output
instead (``tests/golden/reference_digests.json``,
written by ``experiments/reference_digests.py``): ``digests`` computes the
same SHA-256s of a run of the port.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import CallerConfig, preset
from ..io.bam import BamFile
from .simulate import make_reference, plant_snps, simulate_bam

# tests/golden/ beside the package, in a checkout of the repository
GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "golden")

GOLDEN_NAMES = ("ont-cdna", "ont-drna", "hifi-isoseq", "exon_only")

# the enumeration inputs held to the JAX package's digests, as keyword
# arguments of make_genome_workload: run "enum" (twelve loci of 4 SNPs),
# run "enum_deep" (four loci of 6 SNPs and four of 10, 432 and 510 reads)
# and the transcriptome-scale input: a sample's many small genes, 8 contigs
# of 40 loci whose lengths cycle through 1.8 to 9 kb (a SNP every 900 bp,
# 1 to 9 a locus) and whose depths cycle through 15x to 120x of 1.5 kb
# reads (a read lies wholly inside its locus, so a 1.8 kb locus cannot take
# a 3 kb read): 320 loci, 62,028 reads
_TX_LENS = (1_800, 2_700, 3_600, 5_400, 7_200, 9_000)
_TX_DEPTHS = (15, 30, 60, 120)
ENUM_INPUTS = {
    "enum": dict(contigs=[(f"chrE{c}", [(4_000, 40, 900)] * 4)
                          for c in range(3)], seed=20_261_016),
    "enum_deep": dict(contigs=[("chrF0", [(5_400, 240, 900)] * 4),
                               ("chrF1", [(9_000, 170, 900)] * 4)],
                      seed=20_261_017),
    "transcriptome": dict(
        contigs=[(f"chrT{c}", [(_TX_LENS[k % 6], _TX_DEPTHS[k % 4], 900)
                               for k in range(40 * c, 40 * c + 40)])
                 for c in range(8)],
        seed=20_261_018, read_len=1_500),
}
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


def digests(vcf_path: str, bam_path: str) -> Dict[str, object]:
    """SHA-256 of a run's VCF record lines and of its sorted tag lines
    (``records_and_tags``), and their counts."""
    records, tags = records_and_tags(vcf_path, bam_path)
    sha = lambda lines: hashlib.sha256("".join(lines).encode()).hexdigest()
    return {"records_sha256": sha(records), "tags_sha256": sha(tags),
            "n_records": len(records), "n_tagged": len(tags)}


def reference_digests() -> Dict[str, dict]:
    """The frozen digests of the JAX package's runs, by input; an input
    whose reference run did not finish has ``"ok": false``."""
    with open(os.path.join(GOLDEN_DIR, "reference_digests.json")) as f:
        return json.load(f)["inputs"]


def same_as_reference(label: str, vcf_path: str, bam_path: str) -> bool:
    """Whether a run of input ``label`` wrote the reference's records and
    tags (False where they differ; KeyError where no digest exists)."""
    want = reference_digests()[label]
    if not want.get("ok"):
        raise KeyError(f"no reference digest of {label}")
    got = digests(vcf_path, bam_path)
    return all(got[k] == want[k] for k in got)
