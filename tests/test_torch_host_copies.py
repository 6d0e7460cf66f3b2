"""The torch port's own host modules against the JAX package's originals.

``longcallr_tpu_torch`` imports nothing of ``longcallr_tpu``: config, BGZF /
BAM / BAI / FASTA / VCF I/O, the native decoders, regions, pileup,
annotation, somatic, the CLI parser and the workload generators are copies.
Each case sends the same input — simulated from a numpy seed — through the
original and through the copy. Tolerance: equality (bytes, arrays, fields);
BGZF files are compared by their payload, and by their compressed bytes too
when both packages' native builds deflate with the same codec.
"""

import copy
import dataclasses
import io
import os
from types import SimpleNamespace

import numpy as np
import pytest

import simulate as jsim
from longcallr_tpu import cli as jcli
from longcallr_tpu import config as jconfig
from longcallr_tpu import native as jnative
from longcallr_tpu.io import bai as jbai
from longcallr_tpu.io import bam as jbam
from longcallr_tpu.io import bgzf as jbgzf
from longcallr_tpu.io import fasta as jfasta
from longcallr_tpu.io import vcf as jvcf
from longcallr_tpu.ops import somatic as jsomatic
from longcallr_tpu.pipeline import annotation as janno
from longcallr_tpu.tiles import pileup as jpileup
from longcallr_tpu.tiles import regions as jregions
from longcallr_tpu.utils import bench_workload as jbench
from longcallr_tpu_torch import cli as tcli
from longcallr_tpu_torch import config as tconfig
from longcallr_tpu_torch import native as tnative
from longcallr_tpu_torch.io import bai as tbai
from longcallr_tpu_torch.io import bam as tbam
from longcallr_tpu_torch.io import bgzf as tbgzf
from longcallr_tpu_torch.io import fasta as tfasta
from longcallr_tpu_torch.io import vcf as tvcf
from longcallr_tpu_torch.ops import somatic as tsomatic
from longcallr_tpu_torch.pipeline import annotation as tanno
from longcallr_tpu_torch.tiles import pileup as tpileup
from longcallr_tpu_torch.tiles import regions as tregions
from longcallr_tpu_torch.utils import bench_workload as tbench
from longcallr_tpu_torch.utils import simulate as tsim
from longcallr_tpu_torch.utils.adopt import adopt

SEED = 4242


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same_deflate() -> bool:
    """Each package builds decode.cpp on its own, with libdeflate where the
    build finds it and zlib otherwise; compressed bytes are comparable only
    when both builds took the same codec."""
    return (jnative.lib().bgzf_native_backend()
            == tnative.lib().bgzf_native_backend())


def _assert_same_bgzf(a_path, b_path):
    """Two BGZF files hold the same payload, and the same bytes when both
    packages deflate with the same codec."""
    assert (bytes(jbgzf.decompress_file(a_path))
            == bytes(jbgzf.decompress_file(b_path)))
    if _same_deflate():
        assert _read(a_path) == _read(b_path)


def _simulate(sim, path, seed=SEED, **kw):
    """One simulated BAM (+ FASTA beside it) from ``seed`` through the
    simulator module ``sim``. Returns (bam path, reference array)."""
    rng = np.random.default_rng(seed)
    ref = sim.make_reference(rng, 12000)
    truth = sim.plant_snps(rng, ref, n_het=14, n_hom=3, min_gap=400)
    sim.simulate_bam(str(path), rng, ref, truth, n_reads=120, read_len=2500,
                     err_rate=0.02, **kw)
    return str(path), ref


@pytest.fixture(scope="module")
def sim_bam(tmp_path_factory):
    """The same simulated BAM written by each package's simulator and
    writer: (JAX package's path, port's path, reference)."""
    d = tmp_path_factory.mktemp("host_copies")
    jp, ref = _simulate(jsim, d / "jax.bam", with_introns=True)
    tp, _ = _simulate(tsim, d / "torch.bam", with_introns=True)
    return jp, tp, ref


# --- BGZF and BAM ---------------------------------------------------------

@pytest.mark.parametrize("what", ["bam_bytes", "fasta_bytes", "inflate",
                                  "deflate_roundtrip", "records",
                                  "columns", "rewrite"])
def test_bgzf_and_bam(sim_bam, tmp_path, what):
    jp, tp, _ = sim_bam
    if what == "bam_bytes":       # simulator + BamWriter + BgzfWriter
        _assert_same_bgzf(jp, tp)
        assert len(_read(tp)) > 20000
    elif what == "fasta_bytes":
        assert (_read(jp.replace(".bam", ".fa"))
                == _read(tp.replace(".bam", ".fa")))
        assert (_read(jp.replace(".bam", ".fa.fai"))
                == _read(tp.replace(".bam", ".fa.fai")))
    elif what == "inflate":
        a = bytes(jbgzf.decompress_file(jp))
        b = bytes(tbgzf.decompress_file(jp))
        assert a == b and len(a) > 100000
    elif what == "deflate_roundtrip":
        payload = np.random.default_rng(SEED).integers(
            0, 7, size=300000, dtype=np.uint8).tobytes()
        paths = []
        for mod, name in ((jbgzf, "j.bgzf"), (tbgzf, "t.bgzf")):
            paths.append(str(tmp_path / name))
            with open(paths[-1], "wb") as f, mod.BgzfWriter(f) as w:
                w.write(payload)
            assert bytes(mod.decompress_file(paths[-1])) == payload
        _assert_same_bgzf(*paths)
    elif what == "records":
        a, b = jbam.BamFile(jp), tbam.BamFile(jp)
        assert a.n_records == b.n_records > 0
        assert a.references == b.references and a.lengths == b.lengths
        assert a.header_text == b.header_text
        for i in range(0, a.n_records, 7):
            ra, rb = a.read(i), b.read(i)
            assert (ra.qname, ra.flag, ra.pos, ra.mapq, ra.ref_id) == \
                (rb.qname, rb.flag, rb.pos, rb.mapq, rb.ref_id)
            assert np.array_equal(ra.cigar, rb.cigar)
            assert bytes(ra.seq) == bytes(rb.seq)
            assert np.array_equal(ra.qual, rb.qual)
            assert ra.aux_bytes() == rb.aux_bytes()
            assert ra.get_tag("de") == rb.get_tag("de")
            assert ra.reference_end() == rb.reference_end()
    elif what == "columns":
        a, b = jbam.BamFile(jp), tbam.BamFile(jp)
        for name in ("pos", "flag", "mapq", "ref_id"):
            assert np.array_equal(getattr(a, name), getattr(b, name)), name
        assert np.array_equal(
            jbam.tagged_record_indices(a, "chrS", 1000, 9000),
            tbam.tagged_record_indices(b, "chrS", 1000, 9000))
    else:
        # tagged rewrite of the same records through each writer
        paths = []
        for mod, name in ((jbam, "j_tag.bam"), (tbam, "t_tag.bam")):
            src = mod.BamFile(jp)
            asg = {src.read(i).qname: 1 + i % 2
                   for i in range(src.n_records)}
            ps = {q: 501 for q in asg}
            paths.append(str(tmp_path / name))
            with mod.BamWriter(paths[-1], src.references, src.lengths,
                               header_text=src.header_text) as w:
                n = mod.write_tagged_records(
                    src, list(range(src.n_records)), asg, ps, w)
            assert n == src.n_records
        _assert_same_bgzf(*paths)
        assert tbam.BamFile(paths[1]).read(3).get_tag("PS") == 501


# --- BAI ------------------------------------------------------------------

@pytest.mark.parametrize("what", ["bai_bytes", "reg2bin", "chunk_span",
                                  "windowed_load"])
def test_bai(sim_bam, tmp_path, what):
    jp, _, _ = sim_bam
    ja = jbai.build_bai(jp, str(tmp_path / "j.bai"))
    ta = tbai.build_bai(jp, str(tmp_path / "t.bai"))
    if what == "bai_bytes":
        assert _read(ja) == _read(ta) and len(_read(ja)) > 32
    elif what == "reg2bin":
        r = np.random.default_rng(SEED)
        for beg in r.integers(0, 1 << 28, size=50).tolist():
            end = beg + int(r.integers(1, 1 << 16))
            assert jbai.reg2bin(beg, end) == tbai.reg2bin(beg, end)
            assert jbai.reg2bins(beg, end) == tbai.reg2bins(beg, end)
    elif what == "chunk_span":
        a, b = jbai.BaiIndex.load(ja), tbai.BaiIndex.load(ta)
        for beg, end in ((0, 12000), (3000, 4000), (11000, 11500)):
            assert a.chunk_span(0, beg, end) == b.chunk_span(0, beg, end)
    else:
        import shutil
        shutil.copy(ja, jp + ".bai")
        try:
            a = jbam.BamFile(jp, region=("chrS", 3000, 6000))
            b = tbam.BamFile(jp, region=("chrS", 3000, 6000))
            assert a.n_records == b.n_records > 0
            assert np.array_equal(a.pos, b.pos)
        finally:
            os.remove(jp + ".bai")


# --- FASTA ----------------------------------------------------------------

@pytest.mark.parametrize("line_width", [60, 17])
def test_fasta_round_trip(tmp_path, line_width):
    r = np.random.default_rng(SEED)
    contigs = {"c1": bytes(jsim.make_reference(r, 1234)),
               "c2": bytes(jsim.make_reference(r, 77))}
    jp, tp = str(tmp_path / "j.fa"), str(tmp_path / "t.fa")
    jfasta.write_fasta(jp, contigs, line_width=line_width)
    tfasta.write_fasta(tp, contigs, line_width=line_width)
    assert _read(jp) == _read(tp) and _read(jp + ".fai") == _read(tp + ".fai")
    assert jfasta.parse_fai(jp + ".fai") == tfasta.parse_fai(tp + ".fai")
    a, b = jfasta.FastaFile(jp), tfasta.FastaFile(jp)
    assert a.contig_lengths == b.contig_lengths
    for name, seq in contigs.items():
        assert bytes(a.fetch(name)) == bytes(b.fetch(name)) == seq
        assert a.length(name) == b.length(name)


# --- VCF ------------------------------------------------------------------

def _candidate_set(rng, n):
    """A synthetic CandidateSet-shaped object that reaches every branch of
    format_region_records (the fields of ops/candidates.CandidateSet)."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    return SimpleNamespace(
        n=n, chrom="chrT",
        pos=np.sort(rng.choice(50000, size=n, replace=False)).astype(np.int64),
        ref_base=bases[rng.integers(0, 4, n)],
        alleles=bases[rng.integers(0, 4, (n, 2))],
        allele_freqs=rng.random((n, 2)).astype(np.float32),
        alt_frac=rng.random((n, 2)).astype(np.float32),
        depth=rng.integers(5, 200, n).astype(np.int32),
        variant_quality=rng.random(n) * 300,
        genotype_quality=rng.random(n) * 120,
        genotype_prob=rng.random((n, 3)),
        variant_type=rng.integers(0, 4, n).astype(np.int8),
        genotype=rng.integers(-1, 3, n).astype(np.int8),
        haplotype=rng.choice([-1, 1], n).astype(np.int8),
        rna_editing=rng.random(n) < 0.15,
        cand_somatic=rng.random(n) < 0.1,
        dense=rng.random(n) < 0.15,
        hom_var=rng.random(n) < 0.3,
        het_var=rng.random(n) < 0.6,
        for_phasing=rng.random(n) < 0.8,
        single=rng.random(n) < 0.1,
        non_selected=rng.random(n) < 0.2,
        somatic=rng.random(n) < 0.1,
        somatic_score=rng.random(n) * 40,
        phase_score=rng.random(n) * 40,
        phase_set=rng.integers(0, 3, n).astype(np.uint32) * 1000,
    )


@pytest.mark.parametrize("what", ["records", "header", "as_i32",
                                  "input_vcf"])
def test_vcf(tmp_path, what):
    rng = np.random.default_rng(SEED)
    if what == "records":
        for min_ps in (0.0, 11.0, 25.0):
            cs = _candidate_set(rng, 300)
            a = jvcf.format_region_records(copy.deepcopy(cs), min_ps)
            b = tvcf.format_region_records(copy.deepcopy(cs), min_ps)
            assert a == b and len(a) > 50
    elif what == "header":
        contigs = [("chr1", 1000), ("chrS", 12000)]
        fa, fb = io.StringIO(), io.StringIO()
        jvcf.write_vcf_header(fa, contigs)
        tvcf.write_vcf_header(fb, contigs)
        assert fa.getvalue() == fb.getvalue()
        assert fa.getvalue().startswith("##fileformat=VCF")
    elif what == "as_i32":
        xs = np.concatenate([rng.random(50) * 1e4, [np.inf, -np.inf, np.nan,
                                                    2.0 ** 40, -2.0 ** 40]])
        assert [jvcf._as_i32(x) for x in xs] == [tvcf._as_i32(x) for x in xs]
    else:
        path = str(tmp_path / "in.vcf")
        with open(path, "w") as f:
            f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                    "FILTER\tINFO\tFORMAT\ts\n")
            for i, gt in enumerate(("0/1", "1/1", "0/0", "1|0", "1/2")):
                f.write(f"chrS\t{100 + 10 * i}\t.\tA\tG\t{30 + i}\tPASS\t.\t"
                        f"GT:GQ\t{gt}:{20 + i}\n")
        a = jvcf.load_input_candidates(path)
        b = tvcf.load_input_candidates(path)
        assert a.keys() == b.keys() == {"chrS"}
        assert ({p: dataclasses.astuple(g) for p, g in a["chrS"].items()}
                == {p: dataclasses.astuple(g) for p, g in b["chrS"].items()})
        assert len(a["chrS"]) >= 4


# --- regions --------------------------------------------------------------

def _region_tuple(r):
    return dataclasses.astuple(r)


@pytest.mark.parametrize("preset_name", jconfig.PRESET_NAMES)
def test_region_lists(sim_bam, preset_name):
    jp, _, ref = sim_bam
    contigs = [("chrS", len(ref))]
    a = jregions.extract_isolated_regions_parallel(
        jbam.BamFile(jp), contigs, jconfig.preset(preset_name))
    b = tregions.extract_isolated_regions_parallel(
        tbam.BamFile(jp), contigs, tconfig.preset(preset_name))
    assert [_region_tuple(r) for r in a] == [_region_tuple(r) for r in b]
    assert a and isinstance(b[0], tregions.Region)
    for text in ("chr1:100-2000", "chrX"):
        assert (_region_tuple(jregions.Region.parse(text))
                == _region_tuple(tregions.Region.parse(text)))
    assert str(a[0]) == str(b[0])


# --- pileup ---------------------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("preset_name", ["hifi-masseq", "ont-cdna"])
def test_pileup_tensors(sim_bam, preset_name, use_native):
    """Every array of PileupTensors, through each package's own native
    library (decode.cpp built by each) and through the numpy path."""
    jp, _, ref = sim_bam
    if use_native:
        assert jnative.available() and tnative.available()
    region = ("chrS", 1, len(ref) + 1)
    a = jpileup.build_pileup(jbam.BamFile(jp), jregions.Region(*region), ref,
                             jconfig.preset(preset_name),
                             use_native=use_native)
    b = tpileup.build_pileup(tbam.BamFile(jp), tregions.Region(*region), ref,
                             tconfig.preset(preset_name),
                             use_native=use_native)
    assert isinstance(b, tpileup.PileupTensors)
    names = [f.name for f in dataclasses.fields(a) if f.name != "region"]
    assert names == [f.name for f in dataclasses.fields(b)
                     if f.name != "region"]
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name
    assert a.cnt.sum() > 100000
    assert _region_tuple(a.region) == _region_tuple(b.region)


# --- annotation -----------------------------------------------------------

_GTF = ('chrS\tsrc\tgene\t500\t4000\t.\t+\t.\tgene_id "G1";\n'
        'chrS\tsrc\tCDS\t600\t1500\t.\t+\t.\tgene_id "G1";\n'
        'chrS\tsrc\tCDS\t2500\t3900\t.\t+\t.\tgene_id "G1";\n'
        'chrS\tsrc\tgene\t3500\t9000\t.\t-\t.\tgene_id "G2";\n'
        'chrS\tsrc\tCDS\t5000\t8000\t.\t-\t.\tgene_id "G2";\n'
        'chrT\tsrc\tgene\t10\t900\t.\t+\t.\tgene_id "G3";\n')


@pytest.mark.parametrize("merge", [True, False])
def test_annotation_intersection(tmp_path, merge):
    path = str(tmp_path / "a.gtf")
    with open(path, "w") as f:
        f.write(_GTF)
    jg, je = janno.parse_annotation(path)
    tg, te = tanno.parse_annotation(path)
    assert je == te
    assert ({c: [_region_tuple(r) for r in v] for c, v in jg.items()}
            == {c: [_region_tuple(r) for r in v] for c, v in tg.items()})
    spans = [("chrS", 100, 700, 10), ("chrS", 1200, 3600, 40),
             ("chrS", 3800, 9500, 25), ("chrT", 1, 50, 5),
             ("chrU", 1, 500, 7)]
    a = janno.intersect_gene_regions(
        [jregions.Region(*s) for s in spans], jg, merge=merge)
    b = tanno.intersect_gene_regions(
        [tregions.Region(*s) for s in spans], tg, merge=merge)
    assert [_region_tuple(r) for r in a] == [_region_tuple(r) for r in b]
    assert a


# --- somatic --------------------------------------------------------------

@pytest.mark.parametrize("purity", [0.3, 0.6])
def test_detect_somatic_by_het(purity):
    """The fragment-cell path on a synthetic matrix: one haplotype carries
    a few alt cells at the flagged sites."""
    rng = np.random.default_rng(SEED)
    K, I = 80, 12
    p = np.ones((K, I), np.int8)
    asg = (1 + np.arange(K) % 2).astype(np.int8)
    for i in range(0, I, 2):                  # alt cells on one haplotype
        rows = rng.choice(np.nonzero(asg == 1 + (i // 2) % 2)[0],
                          size=5 + i, replace=False)
        p[rows, i] = -1
    p[rng.random((K, I)) < 0.1] = 0
    frags = SimpleNamespace(n_frags=K, assignment=asg, p=p,
                            baseq=rng.integers(10, 40, (K, I)).astype(np.uint8))
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref_base = bases[rng.integers(0, 4, I)]
    alt = bases[(np.searchsorted(bases, ref_base) + 1) % 4]

    def cands():
        return SimpleNamespace(
            cand_somatic=np.arange(I) % 2 == 0, ref_base=ref_base,
            alleles=np.stack([ref_base, alt], axis=1),
            somatic=np.zeros(I, bool), somatic_score=np.zeros(I),
            variant_type=np.zeros(I, np.int8))

    a, b = cands(), cands()
    jsomatic.detect_somatic_by_het(frags, a, purity)
    tsomatic.detect_somatic_by_het(frags, b, purity)
    assert np.array_equal(a.somatic, b.somatic)
    assert np.array_equal(a.somatic_score, b.somatic_score)
    assert np.array_equal(a.variant_type, b.variant_type)
    assert a.somatic.any()
    qs = [rng.integers(5, 40, n) for n in (9, 3, 11, 0)]
    assert (jsomatic.calculate_prob_somatic(*qs, purity)
            == tsomatic.calculate_prob_somatic(*qs, purity))


# --- config ---------------------------------------------------------------

@pytest.mark.parametrize("name", jconfig.PRESET_NAMES)
def test_presets_field_by_field(name):
    assert jconfig.PRESET_NAMES == tconfig.PRESET_NAMES
    a = jconfig.preset(name, threads=3, min_mapq=None)
    b = tconfig.preset(name, threads=3, min_mapq=None)
    fa, fb = dataclasses.fields(a), dataclasses.fields(b)
    assert [f.name for f in fa] == [f.name for f in fb]
    for f in fa:
        assert getattr(a, f.name) == getattr(b, f.name), f.name
        assert type(getattr(a, f.name)) is type(getattr(b, f.name)), f.name
    assert jconfig.MAX_BASE_QUALITY == tconfig.MAX_BASE_QUALITY
    assert dataclasses.asdict(a.replace(exon_only=True)) == \
        dataclasses.asdict(b.replace(exon_only=True))


# --- the CLI's parser -----------------------------------------------------

def _options(parser):
    return {a.dest + "|" + ",".join(a.option_strings): a
            for a in parser._actions}


_PARSERS = (_options(jcli.build_parser()), _options(tcli.build_parser()))


def test_parser_has_the_same_options():
    assert list(_PARSERS[0]) == list(_PARSERS[1]) and len(_PARSERS[0]) > 45


@pytest.mark.parametrize("key", sorted(_PARSERS[0]))
def test_parser_option(key):
    """One option of the JAX package's parser: the port's has the same
    flags, destination, default, arity, choices, requiredness and help."""
    a, b = _PARSERS[0][key], _PARSERS[1][key]
    assert type(a) is type(b)
    for attr in ("option_strings", "dest", "default", "nargs", "const",
                 "required", "help", "metavar"):
        assert getattr(a, attr) == getattr(b, attr), attr
    assert (list(a.choices) if a.choices is not None else None) == \
        (list(b.choices) if b.choices is not None else None)
    if a.type is not b.type:      # the --strand-bias lambda: same mapping
        for text in ("true", "True", "false", "no"):
            assert a.type(text) == b.type(text)


@pytest.mark.parametrize("argv", [
    ["-p", "hifi-masseq"],
    ["-p", "ont-cdna", "-t", "4", "--min-mapq", "7", "--strand-bias", "false",
     "--somatic", "--somatic-purity", "0.5", "--exon-only", "--downsample",
     "--bam-compression-level", "1", "--min-phase-score", "8.5"],
])
def test_config_from_args(argv):
    base = ["-b", "x.bam", "-f", "x.fa", "-o", "out"]
    a = jcli.config_from_args(jcli.build_parser().parse_args(base + argv))
    b = tcli.config_from_args(tcli.build_parser().parse_args(base + argv))
    assert isinstance(b, tconfig.CallerConfig)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# --- workload generators --------------------------------------------------

def test_make_deep_workload_byte_equal(tmp_path):
    """make_deep_workload at a reduced size: BAM, FASTA, index and params."""
    kw = dict(n_regions=2, region_len=6000, coverage=12, read_len=1500,
              snp_spacing=300, seed=SEED)
    outs = []
    for mod, d in ((jbench, tmp_path / "j"), (tbench, tmp_path / "t")):
        os.makedirs(d)
        bam, fa = str(d / "deep.bam"), str(d / "deep.fa")
        params = mod.make_deep_workload(bam, fa, **kw)
        outs.append((bam, params, _read(fa), _read(fa + ".fai")))
    assert outs[0][1:] == outs[1][1:]
    _assert_same_bgzf(outs[0][0], outs[1][0])
    assert outs[0][1]["n_reads"] > 50


def test_simulate_bam_byte_equal(tmp_path):
    """The port's simulator against tests/simulate.py: soft clips, no ts
    tags, a strand-biased site."""
    outs = []
    for sim, name in ((jsim, "j.bam"), (tsim, "t.bam")):
        rng = np.random.default_rng(SEED + 1)
        ref = sim.make_reference(rng, 7000)
        truth = sim.plant_snps(rng, ref, n_het=6, n_hom=2, n_tri=1)
        path = str(tmp_path / name)
        sim.simulate_bam(path, rng, ref, truth, n_reads=40, read_len=2000,
                         err_rate=0.01, ts_tags=False,
                         biased_sites={3000: int(ref[3001])})
        outs.append((path, _read(path.replace(".bam", ".fa")),
                     truth.het_snps, truth.hom_snps, truth.tri_snps,
                     truth.hap_of_read))
    assert outs[0][1:] == outs[1][1:]
    _assert_same_bgzf(outs[0][0], outs[1][0])
    p1, p2 = str(tmp_path / "sc_j.bam"), str(tmp_path / "sc_t.bam")
    for sim, path in ((jsim, p1), (tsim, p2)):
        _simulate(sim, path, seed=SEED + 2, softclip=12)
    _assert_same_bgzf(p1, p2)


# --- carrying one package's objects into the other's types -----------------

@pytest.mark.parametrize("what", ["config", "region", "pileup", "refused"])
def test_adopt(sim_bam, what):
    jp, _, ref = sim_bam
    if what == "config":
        a = jconfig.preset("ont-drna", threads=5)
        b = adopt(a)
        assert type(b) is tconfig.CallerConfig
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert adopt(b) is b
    elif what == "region":
        a = jregions.Region("chrS", 10, 900, max_coverage=33, gene_id="G")
        b = adopt(a)
        assert type(b) is tregions.Region
        assert _region_tuple(a) == _region_tuple(b)
    elif what == "pileup":
        a = jpileup.build_pileup(jbam.BamFile(jp),
                                 jregions.Region("chrS", 1, len(ref) + 1),
                                 ref, jconfig.preset("hifi-masseq"))
        b = adopt(a)
        assert type(b) is tpileup.PileupTensors
        assert type(b.region) is tregions.Region
        assert b.cnt is a.cnt and b.length == a.length
        # the adopted pileup goes through the port's candidate selection
        from longcallr_tpu.ops.candidates import select_candidates as jsel
        from longcallr_tpu_torch.ops.candidates import \
            select_candidates as tsel
        want = jsel(a, jconfig.preset("hifi-masseq"))
        got = tsel(b, adopt(jconfig.preset("hifi-masseq")))
        assert np.array_equal(want.pos, got.pos) and want.n > 5
        assert np.array_equal(want.genotype, got.genotype)
    else:
        with pytest.raises(TypeError):
            adopt(SimpleNamespace(x=1))
        with pytest.raises(TypeError):
            adopt(3)
