"""The torch port's ASE/ASJ tools (``longcallr_tpu_torch.analysis``), its
``utils/stats.py`` and ``utils/intervals.py`` against the JAX package's.

The cases of ``tests/test_analysis.py`` and ``tests/test_oracle_analysis.py``
that touch ase / asj / asj_to_bed / stats / intervals, each run through the
port's modules on the same seeded inputs: the output tables equal the JAX
package's line for line (and the scalar oracles'), and the behaviour each
original case asserts holds for the port. The phased BAMs come from the
port's own caller on the CPU. Tolerance: equality of tables and values.
"""

import io
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from longcallr_tpu.analysis import ase as jase
from longcallr_tpu.analysis import asj as jasj
from longcallr_tpu.analysis import asj_to_bed as jbed
from longcallr_tpu.utils import intervals as jintervals
from longcallr_tpu.utils import stats as jstats
from longcallr_tpu_torch.analysis import ase, asj, asj_to_bed
from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.io import bam as bamio
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.io.fasta import write_fasta
from longcallr_tpu_torch.pipeline.caller import run
from longcallr_tpu_torch.utils import intervals, stats
from longcallr_tpu_torch.utils.simulate import (BASES, haplotype_seq,
                                                make_reference, plant_snps,
                                                simulate_bam)

from oracle_ase import oracle_analyze_ase
from oracle_asj import oracle_analyze_asj
from simulate_analysis import make_scenario

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GENE_TYPES = {"protein_coding"}


def _read(path):
    with open(path) as f:
        return f.read()


def _rows(path):
    return [l.split("\t") for l in _read(path).splitlines()[1:]]


def _write_gtf(path, chrom, genes):
    """genes: list of (gene_id, gene_name, start, end, exons[(s,e)])."""
    with open(path, "w") as f:
        for gid, gname, s, e, exons in genes:
            attrs = (f'gene_id "{gid}"; gene_type "protein_coding"; '
                     f'gene_name "{gname}";')
            f.write(f"{chrom}\thv\tgene\t{s}\t{e}\t.\t+\t.\t{attrs}\n")
            for (es, ee) in exons:
                ta = attrs + f' transcript_id "{gid}.t1";'
                f.write(f"{chrom}\thv\texon\t{es}\t{ee}\t.\t+\t.\t{ta}\n")


def _ase_both(tmp_path, gtf, bam, tag, **kw):
    """analyze_ase_genes of both packages on one input; the tables must be
    equal. Returns the port's table path."""
    paths = []
    for mod, name in ((ase, "torch"), (jase, "jax")):
        paths.append(str(tmp_path / f"{tag}.{name}.tsv"))
        mod.analyze_ase_genes(gtf, bam, paths[-1], threads=1,
                              gene_types=GENE_TYPES, min_support=5,
                              overdispersion=0.001, **kw)
    assert _read(paths[0]) == _read(paths[1])
    return paths[0]


# --- stats and intervals ------------------------------------------------------

@pytest.mark.parametrize("what", ["fdr_bh", "beta_binomial", "scipy",
                                  "many", "tables_2x2", "alpha_beta"])
def test_stats(rng, what):
    if what == "fdr_bh":
        p = [0.01, 0.02, 0.03, 0.5, 0.04]
        rej, adj = stats.fdr_bh(p)
        np.testing.assert_allclose(adj, [0.05, 0.05, 0.05, 0.5, 0.05])
        ps = rng.random(200) ** 3
        for x, y in zip(stats.fdr_bh(ps, 0.1), jstats.fdr_bh(ps, 0.1)):
            np.testing.assert_array_equal(x, y)
        assert rej.dtype == bool
    elif what == "beta_binomial":
        bb = stats.beta_binomial_two_sided
        assert bb(5, 10, 0.5, 0.001) > 0.9          # balanced
        assert bb(50, 50, 0.5, 0.001) < 1e-9        # extreme imbalance
        np.testing.assert_allclose(bb(10, 50, 0.5, 0.001),
                                   bb(40, 50, 0.5, 0.001), rtol=1e-9)
        for k, n in ((0, 1), (3, 7), (40, 50), (120, 400)):
            assert bb(k, n, 0.5, 0.02) == \
                jstats.beta_binomial_two_sided(k, n, 0.5, 0.02)
    elif what == "scipy":
        from scipy.stats import betabinom
        mu, rho = 0.5, 0.02
        a, b = stats.convert_mu_rho_to_alpha_beta(mu, rho)
        for _ in range(20):
            n = int(rng.integers(1, 500))
            k = int(rng.integers(0, n + 1))
            d = betabinom(n, a, b)
            pmf = d.pmf(np.arange(n + 1))
            want = float(pmf[pmf <= d.pmf(k)].sum())
            assert abs(stats.beta_binomial_two_sided(k, n, mu, rho)
                       - want) < 1e-10, (k, n)
    elif what == "many":
        mu, rho = 0.5, 0.02
        ns = rng.integers(1, 500, size=60)
        ks = (rng.random(60) * (ns + 1)).astype(np.int64)
        many = stats.beta_binomial_two_sided_many(ks, ns, mu, rho)
        np.testing.assert_array_equal(
            many, jstats.beta_binomial_two_sided_many(ks, ns, mu, rho))
        scal = [stats.beta_binomial_two_sided(int(k), int(n), mu, rho)
                for k, n in zip(ks, ns)]
        np.testing.assert_allclose(many, scal, rtol=1e-12, atol=1e-14)
        out = stats.beta_binomial_two_sided_many(np.array([0, 2]),
                                                 np.array([0, 7]), mu, rho)
        assert out[0] == 1.0
    elif what == "tables_2x2":
        for _ in range(40):
            t = [int(x) for x in rng.integers(0, 60, size=4)]
            assert stats.fisher_exact_two_sided(*t) == \
                jstats.fisher_exact_two_sided(*t)
            a, b = stats.g_test_2x2(*t), jstats.g_test_2x2(*t)
            assert a == b or (np.isnan(a) and np.isnan(b))
            assert stats.strand_odds_ratio(*t) == \
                jstats.strand_odds_ratio(*t)
            assert asj.calc_sor(*t) == jasj.calc_sor(*t)
    else:
        for mu, rho in ((0.5, 0.001), (0.3, 0.02), (0.9, 0.2)):
            assert stats.convert_mu_rho_to_alpha_beta(mu, rho) == \
                jstats.convert_mu_rho_to_alpha_beta(mu, rho)


@pytest.mark.parametrize("what", ["merge", "overlap", "overlap_length_ref",
                                  "empty"])
def test_intervals(rng, what):
    starts = rng.integers(0, 5000, size=120)
    ivs = [(int(s), int(s + rng.integers(1, 400))) for s in starts]
    a = intervals.IntervalIndex(ivs, data=list(range(len(ivs))))
    b = jintervals.IntervalIndex(ivs, data=list(range(len(ivs))))
    queries = [(int(q), int(q + rng.integers(0, 600)))
               for q in rng.integers(-100, 5600, size=200)]
    if what == "merge":
        got = intervals.merge_intervals(ivs)
        assert got == jintervals.merge_intervals(ivs)
        assert all(x[1] <= y[0] for x, y in zip(got, got[1:])) and got
        assert intervals.merge_intervals([(1, 5), (5, 9)]) == [(1, 5), (5, 9)]
    elif what == "overlap":
        assert len(a) == len(b) == 120
        hits = 0
        for qs, qe in queries:
            assert a.overlap(qs, qe) == b.overlap(qs, qe)
            assert a.overlap_data(qs, qe) == b.overlap_data(qs, qe)
            hits += len(a.overlap(qs, qe))
        assert hits > 100
    elif what == "overlap_length_ref":
        tot = 0
        for qs, qe in queries:
            assert a.overlap_length_ref(qs, qe) == \
                b.overlap_length_ref(qs, qe)
            tot += a.overlap_length_ref(qs, qe)
        assert tot > 0
        # the reference's closed-segment quirk: an exon starting at the
        # segment's last base counts 0
        one = intervals.IntervalIndex([(10, 20)])
        assert one.overlap_length_ref(5, 10) == 0
        assert one.overlap_length_ref(5, 11) == 2
    else:
        e = intervals.IntervalIndex([])
        assert len(e) == 0 and e.overlap(0, 10) == []
        assert a.overlap(7, 7) == []


# --- ASE ----------------------------------------------------------------------

def test_ase_pipeline(tmp_path, rng):
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=10, n_hom=0, min_gap=500)
    bam_path = str(tmp_path / "a.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=80, read_len=4000,
                 err_rate=0.01)
    out = run(bam_path, bam_path.replace(".bam", ".fa"), str(tmp_path / "o"),
              cfg, device=CPU)
    gtf = str(tmp_path / "genes.gtf")
    _write_gtf(gtf, "chrS", [("G1", "GENE1", 1, 4500, [(1, 4500)]),
                             ("G2", "GENE2", 4501, 9000, [(4501, 9000)])])
    tsv = _ase_both(tmp_path, gtf, out.phased_bam_path, "res")
    assert _read(tsv).startswith("#Gene_name")
    rows = _rows(tsv)
    assert len(rows) >= 1
    for r in rows:      # reads were simulated 50/50: no significant ASE
        h1, h2, p = int(r[3]), int(r[4]), float(r[5])
        assert h1 + h2 >= 5 and p > 0.001, r


def _imbalanced_bam(tmp_path, rng, name, ref_len, n_het, min_gap, major,
                    max_pos, span):
    """80 reads with 70/30 haplotype expression, through the port's
    caller. Returns (truth, CallerOutputs)."""
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, ref_len)
    truth = plant_snps(rng, ref, n_het=n_het, n_hom=0, min_gap=min_gap)
    haps = {1: haplotype_seq(truth, ref, 1), 2: haplotype_seq(truth, ref, 2)}
    rows = []
    for i in range(80):
        hap = major if i % 10 < 7 else 3 - major
        pos = int(rng.integers(0, max_pos))
        seq = haps[hap][pos:pos + span].copy()
        errs = rng.random(len(seq)) < 0.01
        seq[errs] = BASES[rng.integers(0, 4, size=int(errs.sum()))]
        rows.append((pos, f"r{i:04d}", seq))
    rows.sort(key=lambda t: t[0])
    bam_path = str(tmp_path / f"{name}.bam")
    with bamio.BamWriter(bam_path, ["chrS"], [len(ref)]) as w:
        for pos, qn, seq in rows:
            w.write_record(qname=qn, flag=0, ref_id=0, pos=pos, mapq=60,
                           cigar=bamio.encode_cigar([(len(seq), "M")]),
                           seq=bytes(seq), qual=np.full(len(seq), 30),
                           tags=bamio.make_tag_bytes("de", "f", 0.001))
    fa = bam_path.replace(".bam", ".fa")
    write_fasta(fa, {"chrS": bytes(ref)})
    return truth, run(bam_path, fa, str(tmp_path / f"{name}_out"), cfg,
                      device=CPU)


def test_ase_detects_imbalance(tmp_path, rng):
    _, out = _imbalanced_bam(tmp_path, rng, "im", 6000, 8, 500, 1, 2000, 3500)
    gtf = str(tmp_path / "g.gtf")
    _write_gtf(gtf, "chrS", [("G1", "GENE1", 1, 6000, [(1, 6000)])])
    rows = _rows(_ase_both(tmp_path, gtf, out.phased_bam_path, "imb"))
    assert len(rows) == 1
    h1, h2, p = int(rows[0][3]), int(rows[0][4]), float(rows[0][5])
    assert max(h1, h2) / (h1 + h2) > 0.6
    assert p < 0.05


def _dna_vcf(path, truth, gt):
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.3\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tS\n")
        for p, (refb, altb) in sorted((truth.het_snps if truth else {}).items()):
            f.write(f"chrS\t{p+1}\t.\t{chr(refb)}\t{chr(altb)}\t60\tPASS\t.\t"
                    f"GT\t{gt}\n")
    return path


def test_ase_patmat_mode(tmp_path, rng):
    """--vcf1 + --vcf2: haplotypes resolved to paternal/maternal via a
    phased DNA VCF."""
    cfg = preset("hifi-masseq").replace(min_read_length=100)
    ref = make_reference(rng, 8000)
    truth = plant_snps(rng, ref, n_het=10, n_hom=0, min_gap=600)
    bam_path = str(tmp_path / "pm.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=60, read_len=4000,
                 err_rate=0.01)
    out = run(bam_path, bam_path.replace(".bam", ".fa"), str(tmp_path / "pm"),
              cfg, device=CPU)
    gtf = str(tmp_path / "pm.gtf")
    _write_gtf(gtf, "chrS", [("G1", "GENE1", 1, 8000, [(1, 8000)])])
    dna = _dna_vcf(str(tmp_path / "dna.vcf"), truth, "0|1")
    tsv = _ase_both(tmp_path, gtf, out.phased_bam_path, "pm.patmat",
                    vcf1=out.vcf_path, vcf2=dna)
    rows = _rows(tsv)
    assert len(rows) == 1
    hdr = _read(tsv).splitlines()[0].split("\t")
    assert hdr[-4:] == ["H1_Paternal", "H1_Maternal", "H2_Paternal",
                        "H2_Maternal"]
    h1p, h1m, h2p, h2m = (int(x) for x in rows[0][6:10])
    assert h1p + h1m > 0 and h2p + h2m > 0
    assert (h1p == 0 or h1m == 0) and (h2p == 0 or h2m == 0)
    assert (h1p > 0) != (h2p > 0)      # opposite parents


def test_ase_filtering_mode(tmp_path, rng):
    """--vcf1 + --vcf3: a gene stays only with a DNA-supported phase-set
    variant of imbalanced allele fraction."""
    truth, out = _imbalanced_bam(tmp_path, rng, "fm", 8000, 10, 600, 2, 3000,
                                 4500)
    gtf = str(tmp_path / "fm.gtf")
    _write_gtf(gtf, "chrS", [("G1", "GENE1", 1, 8000, [(1, 8000)])])
    dna = _dna_vcf(str(tmp_path / "dna3.vcf"), truth, "0/1")
    rows = _rows(_ase_both(tmp_path, gtf, out.phased_bam_path, "kept",
                           vcf1=out.vcf_path, vcf3=dna))
    assert len(rows) == 1              # retained: DNA-supported
    empty = _dna_vcf(str(tmp_path / "empty.vcf"), None, "0/1")
    rows2 = _rows(_ase_both(tmp_path, gtf, out.phased_bam_path, "dropped",
                            vcf1=out.vcf_path, vcf3=empty))
    assert len(rows2) == 0


# --- ASJ ----------------------------------------------------------------------

def _junction_inputs(tmp_path, rng):
    """A junction present only on hap1 reads, and one shared by both."""
    L = 9000
    ref = make_reference(rng, L)
    ref[2000:2002] = np.frombuffer(b"GT", np.uint8)
    ref[2497:2499] = np.frombuffer(b"AG", np.uint8)
    ref[4500:4502] = np.frombuffer(b"GT", np.uint8)
    ref[4997:4999] = np.frombuffer(b"AG", np.uint8)
    fa_path = str(tmp_path / "asj.fa")
    write_fasta(fa_path, {"chrS": bytes(ref)})
    gtf = str(tmp_path / "asj.gtf")
    attrs = 'gene_id "G1"; gene_type "protein_coding"; gene_name "GENE1";'
    with open(gtf, "w") as f:
        f.write(f"chrS\thv\tgene\t1\t9000\t.\t+\t.\t{attrs}\n")
        for (s, e) in [(1, 2000), (2500, 4500), (5000, 9000)]:
            f.write(f'chrS\thv\texon\t{s}\t{e}\t.\t+\t.\t{attrs} '
                    f'transcript_id "G1.t1";\n')
    bam_path = str(tmp_path / "asj.bam")
    with bamio.BamWriter(bam_path, ["chrS"], [L]) as w:
        for i in range(40):
            hap = 1 if i % 2 == 0 else 2
            tags = (bamio.make_tag_bytes("HP", "i", hap)
                    + bamio.make_tag_bytes("PS", "i", 1000))
            if hap == 1:            # both introns spliced out
                cigar = bamio.encode_cigar([(2000, "M"), (499, "N"),
                                            (2001, "M"), (499, "N"),
                                            (3500, "M")])
                seq = np.concatenate([ref[0:2000], ref[2499:4500],
                                      ref[4999:8499]])
            else:                   # intron1 retained
                cigar = bamio.encode_cigar([(4500, "M"), (499, "N"),
                                            (3500, "M")])
                seq = np.concatenate([ref[0:4500], ref[4999:8499]])
            w.write_record(qname=f"j{i:03d}", flag=0, ref_id=0, pos=0,
                           mapq=60, cigar=cigar, seq=bytes(seq),
                           qual=np.full(len(seq), 30), tags=tags)
    return gtf, bam_path, fa_path


_ASJ_TABLES = (".asj.tsv", ".asj_gene.tsv", ".gene_coverage.tsv")


def test_asj_detects_haplotype_specific_junction(tmp_path, rng):
    gtf, bam_path, fa_path = _junction_inputs(tmp_path, rng)
    prefix, jprefix = str(tmp_path / "t"), str(tmp_path / "j")
    for mod, pre in ((asj, prefix), (jasj, jprefix)):
        mod.analyze(gtf, bam_path, fa_path, pre, min_count=5,
                    gene_types=GENE_TYPES, min_junctions=0)
    for ext in _ASJ_TABLES:
        assert _read(prefix + ext) == _read(jprefix + ext), ext
    by_junc = {r[0]: r for r in _rows(prefix + ".asj.tsv")}
    j1, j2 = by_junc["chrS:2001-2499"], by_junc["chrS:4501-4999"]
    assert float(j1[8]) < 1e-4, j1       # hap1 present / hap2 absent
    assert j1[11] == "True"              # GT-AG canonical
    assert j1[10] == "False"             # annotated, not novel
    assert float(j2[8]) > 0.05, j2       # both haplotypes
    gene_rows = _read(prefix + ".asj_gene.tsv").splitlines()[1:]
    assert len(gene_rows) == 1 and gene_rows[0].startswith("GENE1")
    cov = _read(prefix + ".gene_coverage.tsv").splitlines()[1]
    assert cov.startswith("GENE1") and int(cov.split("\t")[4]) == 40


def test_asj_to_bed(tmp_path, rng):
    gtf, bam_path, fa_path = _junction_inputs(tmp_path, rng)
    prefix = str(tmp_path / "t")
    asj.analyze(gtf, bam_path, fa_path, prefix, min_count=5,
                gene_types=GENE_TYPES, min_junctions=0)
    bufs = []
    for mod in (asj_to_bed, jbed):
        bufs.append(io.StringIO())
        mod.convert_asj_to_bed(prefix + ".asj.tsv", 1e-4, out=bufs[-1])
    bed = bufs[0].getvalue().splitlines()
    assert bufs[0].getvalue() == bufs[1].getvalue()
    assert len(bed) == 1 and bed[0].startswith("chrS\t2000\t2499\tGENE1")


def test_tools_run_as_modules(tmp_path, rng):
    """python -m longcallr_tpu_torch.analysis.{ase,asj,asj_to_bed}: the
    tables of the functions called directly, and torch is not imported."""
    gtf, bam_path, fa_path = _junction_inputs(tmp_path, rng)
    direct = str(tmp_path / "direct")
    asj.analyze(gtf, bam_path, fa_path, direct, 5, GENE_TYPES, 1, False, 0)
    ase.analyze_ase_genes(gtf, bam_path, direct + ".ase.tsv", 1, GENE_TYPES,
                          5, 0.001)
    prefix = str(tmp_path / "mod")
    calls = [
        ["longcallr_tpu_torch.analysis.asj", "-a", gtf, "-b", bam_path, "-f",
         fa_path, "-o", prefix, "-m", "5", "--min_junctions", "0", "-g",
         "protein_coding"],
        ["longcallr_tpu_torch.analysis.ase", "-a", gtf, "-b", bam_path, "-o",
         prefix, "--min_support", "5", "--gene_types", "protein_coding"],
        ["longcallr_tpu_torch.analysis.asj_to_bed", prefix + ".asj.tsv",
         "1e-4"]]
    for argv in calls:
        res = subprocess.run([sys.executable, "-m", *argv], cwd=REPO,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
    for ext in _ASJ_TABLES + (".ase.tsv",):
        assert _read(prefix + ext) == _read(direct + ext), ext
    assert res.stdout.startswith("chrS\t2000\t2499\tGENE1")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import sys; from longcallr_tpu_torch.analysis import ase, asj, "
         "asj_to_bed; assert ase._fork_pool_ok(); "
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'jax', 'longcallr_tpu')]; assert not bad, bad"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert probe.returncode == 0, probe.stderr[-2000:]


# --- the fork pool --------------------------------------------------------------

def test_fork_pool_is_refused_once_cuda_is_initialised(monkeypatch):
    """The gate looks at torch.cuda.is_initialized() through sys.modules:
    False once CUDA is live, open otherwise; FORK_POOL forces either."""
    monkeypatch.setattr(ase, "FORK_POOL", None)
    stub = types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: True))
    monkeypatch.setitem(sys.modules, "torch", stub)
    assert ase._fork_pool_ok() is False
    stub.cuda.is_initialized = lambda: False
    assert ase._fork_pool_ok() is True
    monkeypatch.delitem(sys.modules, "torch")
    assert ase._fork_pool_ok() is True
    monkeypatch.setitem(sys.modules, "torch", stub)
    stub.cuda.is_initialized = lambda: True
    monkeypatch.setattr(ase, "FORK_POOL", True)
    assert ase._fork_pool_ok() is True
    monkeypatch.setattr(ase, "FORK_POOL", False)
    assert ase._fork_pool_ok() is False


def test_closed_gate_keeps_the_tools_serial(tmp_path, rng, monkeypatch):
    """With CUDA live and threads > 1 no process pool is made, and the
    tables equal the threads=1 run."""
    gtf, bam_path, fa_path = _junction_inputs(tmp_path, rng)
    monkeypatch.setattr(ase, "FORK_POOL", None)
    monkeypatch.setattr(ase, "ASE_CHUNK_MIN", 1)
    stub = types.SimpleNamespace(cuda=types.SimpleNamespace(
        is_initialized=lambda: True))
    monkeypatch.setitem(sys.modules, "torch", stub)
    import concurrent.futures as cf

    def no_pool(*a, **kw):
        raise AssertionError("a process pool was made with CUDA live")

    monkeypatch.setattr(cf, "ProcessPoolExecutor", no_pool)
    for threads, tag in ((3, "mt"), (1, "st")):
        asj.analyze(gtf, bam_path, fa_path, str(tmp_path / tag), min_count=5,
                    gene_types=GENE_TYPES, threads=threads, min_junctions=0)
        ase.analyze_ase_genes(gtf, bam_path, str(tmp_path / tag) + ".ase.tsv",
                              threads, GENE_TYPES, 5, 0.001)
    for ext in _ASJ_TABLES + (".ase.tsv",):
        assert _read(str(tmp_path / "mt") + ext) \
            == _read(str(tmp_path / "st") + ext), ext
    assert len(_rows(str(tmp_path / "mt.asj.tsv"))) >= 2


def _run_pool_script(tmp_path, script, *argv):
    """A pool-equality script in a fresh process, where nothing has
    initialised CUDA (nor imported torch), so the fork pool engages through
    its own gate."""
    drv = str(tmp_path / "pool_script.py")
    with open(drv, "w") as f:
        f.write(script)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, drv, *argv], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "POOL_OK" in r.stdout, r.stdout


_ASE_SCRIPT = r"""
import sys
bam_path, gtf = sys.argv[1:3]
from longcallr_tpu_torch.analysis import ase
from longcallr_tpu_torch.io.bam import BamFile
ase.ASE_CHUNK_MIN = 8
assert ase._fork_pool_ok(), "fork pool gate closed in a fresh process"
assert "torch" not in sys.modules and "jax" not in sys.modules
_, _, _, exon_regions = ase.get_gene_regions(gtf, {"protein_coding"})
merged = ase.merge_gene_exon_regions(exon_regions)
bam = BamFile(bam_path)
serial = ase.assign_reads_to_gene(bam, merged, threads=1)
pooled = ase.assign_reads_to_gene(bam, merged, threads=3)
assert serial and pooled == serial, (len(serial), len(pooled))
print("POOL_OK")
"""


def test_ase_assignment_parallel_equals_serial(tmp_path, rng):
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=8, n_hom=0, min_gap=600)
    bam_path = str(tmp_path / "pp.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=120, read_len=3000,
                 err_rate=0.01, with_introns=True)
    gtf = str(tmp_path / "genes.gtf")
    _write_gtf(gtf, "chrS", [
        ("G1", "GENE1", 1, 4500, [(1, 2000), (2600, 4500)]),
        ("G2", "GENE2", 4501, 9000, [(4501, 9000)])])
    _run_pool_script(tmp_path, _ASE_SCRIPT, bam_path, gtf)


_ASJ_SCRIPT = r"""
import sys
bam_path, gtf = sys.argv[1:3]
from longcallr_tpu_torch.analysis import ase, asj
from longcallr_tpu_torch.io.bam import BamFile
from longcallr_tpu_torch.io.fasta import FastaFile
ase.ASE_CHUNK_MIN = 1
assert ase._fork_pool_ok(), "fork pool gate closed in a fresh process"
_, _, _, exon_regions = ase.get_gene_regions(gtf, {"protein_coding"})
merged = ase.merge_gene_exon_regions(exon_regions)
bam = BamFile(bam_path)
fasta = FastaFile(bam_path.replace(".bam", ".fa"))
serial = asj.load_reads(bam, fasta, merged, no_gtag=False, threads=1)
pooled = asj.load_reads(bam, fasta, merged, no_gtag=False, threads=3)
assert serial[0], "no assignments"
# the duplicate qname whose LAST record has no junctions must be absent
# from positions/tags in BOTH variants (cross-chunk delete semantics)
assert "dup_read" not in serial[1] and "dup_read" not in serial[2]
for a, b in zip(serial, pooled):
    assert a == b
print("POOL_OK")
"""


def test_asj_load_reads_parallel_equals_serial(tmp_path, rng):
    """The fork-pool chunked load_reads equals the serial walk, including a
    duplicate qname whose later record deletes entries across chunks."""
    ref = make_reference(rng, 9000)
    truth = plant_snps(rng, ref, n_het=8, n_hom=0, min_gap=600)
    bam_path = str(tmp_path / "aj.bam")
    simulate_bam(bam_path, rng, ref, truth, n_reads=100, read_len=3000,
                 err_rate=0.01, with_introns=True)
    src = BamFile(bam_path)
    with bamio.BamWriter(bam_path, ["chrS"], [len(ref)]) as w:
        def emit(pos, cigar_items, qname):
            seq = bytes(ref[pos:pos + 600]) + bytes(ref[pos:pos + 600])
            seq = seq[:sum(l for l, op in cigar_items if op in ("M", "I"))]
            w.write_record(qname=qname, flag=0, ref_id=0, pos=pos, mapq=60,
                           cigar=bamio.encode_cigar(cigar_items),
                           seq=seq, qual=np.full(len(seq), 30, np.uint8))
        wrote_dup_early = False
        for i in range(src.n_records):
            r = src.read(i)
            if not wrote_dup_early and r.pos > 200:
                emit(150, [(300, "M"), (200, "N"), (300, "M")], "dup_read")
                wrote_dup_early = True
            w.write_record(qname=r.qname, flag=int(r.flag), ref_id=0,
                           pos=int(r.pos), mapq=int(r.mapq), cigar=r.cigar,
                           seq=bytes(r.seq), qual=r.qual,
                           tags=r.aux_bytes())
        emit(8200, [(600, "M")], "dup_read")   # junction-free, last
    write_fasta(bam_path.replace(".bam", ".fa"), {"chrS": bytes(ref)})
    gtf = str(tmp_path / "genes.gtf")
    _write_gtf(gtf, "chrS", [
        ("G1", "GENE1", 1, 9000, [(1, 4000), (4600, 9000)])])
    _run_pool_script(tmp_path, _ASJ_SCRIPT, bam_path, gtf)


# --- the scalar oracles (tests/test_oracle_analysis.py, same seeds) -------------

def _ase_case(tmp_path, seed, mode):
    rng = np.random.default_rng([4101, seed])
    sc = make_scenario(rng, str(tmp_path))
    min_support = int(rng.integers(1, 9))
    overdispersion = float(rng.choice([0.001, 0.01]))
    gene_types = {"protein_coding", "lncRNA"} if rng.random() < 0.8 \
        else {"protein_coding"}
    kw = {}
    if mode == "patmat":
        kw = dict(vcf1=sc["rna_vcf"], vcf2=sc["dna_phased_vcf"])
    elif mode == "filter":
        kw = dict(vcf1=sc["rna_vcf"], vcf3=sc["dna_vcf"])
    got = []
    for mod, name in ((ase, "torch"), (jase, "jax")):
        out_tsv = str(tmp_path / f"case.{mode}.{name}.tsv")
        mod.analyze_ase_genes(sc["anno"], sc["bam"], out_tsv, threads=1,
                              gene_types=gene_types, min_support=min_support,
                              overdispersion=overdispersion, **kw)
        got.append(_read(out_tsv))
    want = oracle_analyze_ase(
        sc["anno"], sc["bam"], 1, gene_types, min_support, overdispersion,
        vcf1=kw.get("vcf1"), vcf2=kw.get("vcf2"), vcf3=kw.get("vcf3"))
    assert got[0] == want, (seed, mode)
    assert got[0] == got[1], (seed, mode)


def _asj_case(tmp_path, seed, filtering=False):
    rng = np.random.default_rng([4202, seed])
    sc = make_scenario(rng, str(tmp_path))
    min_count = int(rng.integers(1, 8))
    min_junctions = int(rng.integers(0, 3))
    cluster_with_exons = bool(rng.random() < 0.5)
    no_gtag = bool(rng.random() < 0.3)
    gene_types = {"protein_coding", "lncRNA"}
    dna_vcf = rna_vcf = None
    if filtering:
        dna_vcf, rna_vcf = sc["dna_vcf"], sc["rna_vcf"]
    got = []
    for mod, amod, name in ((asj, ase, "torch"), (jasj, jase, "jax")):
        dna_vcfs = rna_vcfs = None
        if filtering:
            dna_vcfs = amod.load_dna_vcf(dna_vcf)
            rna_vcfs = amod.load_longcallr_phased_vcf(rna_vcf,
                                                      with_dp_af=False)
        prefix = str(tmp_path / f"asjcase_{name}")
        mod.analyze(sc["anno"], sc["bam"], sc["fa"], prefix,
                    min_count=min_count, gene_types=gene_types, threads=1,
                    no_gtag=no_gtag, min_junctions=min_junctions,
                    cluster_with_exons=cluster_with_exons,
                    dna_vcfs=dna_vcfs, rna_vcfs=rna_vcfs)
        got.append(tuple(_read(prefix + ext) for ext in _ASJ_TABLES))
    want = oracle_analyze_asj(
        sc["anno"], sc["bam"], sc["fa"], min_count=min_count,
        gene_types=gene_types, no_gtag=no_gtag, min_junctions=min_junctions,
        cluster_with_exons=cluster_with_exons, dna_vcf=dna_vcf,
        rna_vcf=rna_vcf)
    assert got[0][2] == want[2], (seed, "gene_coverage")
    assert got[0][0] == want[0], (seed, "asj")
    assert got[0][1] == want[1], (seed, "asj_gene")
    assert got[0] == got[1], seed


@pytest.mark.parametrize("seed", range(6))
def test_ase_plain_matches_oracle(tmp_path, seed):
    _ase_case(tmp_path, seed, "plain")


@pytest.mark.parametrize("seed", range(6, 10))
def test_ase_patmat_matches_oracle(tmp_path, seed):
    _ase_case(tmp_path, seed, "patmat")


@pytest.mark.parametrize("seed", range(10, 14))
def test_ase_filter_matches_oracle(tmp_path, seed):
    _ase_case(tmp_path, seed, "filter")


@pytest.mark.parametrize("seed", range(8))
def test_asj_matches_oracle(tmp_path, seed):
    _asj_case(tmp_path, seed, filtering=False)


@pytest.mark.parametrize("seed", range(8, 12))
def test_asj_filtering_matches_oracle(tmp_path, seed):
    _asj_case(tmp_path, seed, filtering=True)
