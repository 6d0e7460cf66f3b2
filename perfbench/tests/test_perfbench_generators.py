"""The generators: the same seed gives the same files, another seed other
reads of the same layout, and the files are what the SAM specification
says (read back by the benchmark's reader and by the program's)."""

import filecmp
import os

import numpy as np
import pytest

from harness import bamio, manifest

LAYOUTS = {
    "genome": dict(contigs=[["chrA", [[4000, 30, 400], [2500, 12, 400]]],
                            ["chrB", [[3000, 20, 300]]]], read_len=1500),
    "deep": dict(n_regions=2, region_len=6000, coverage=20, gap=5000),
    "transcripts": dict(n_contigs=2, loci_per_contig=2, tx_lengths=[1800, 3600],
                        coverages=[15, 30], snp_spacing=600, read_len=1500,
                        gap=5000, layout_seed=3),
}
READS = {"genome": 80 + 20 + 40, "deep": 2 * 40, "transcripts": 2 * (18 + 72)}


def _gen(tmp_path, name, seed, tag):
    gen = manifest.generator(name)
    d = tmp_path / tag
    d.mkdir()
    counts = gen.generate(str(d / "in.bam"), str(d / "in.fa"), seed, **LAYOUTS[name])
    return d, counts


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_deterministic_per_seed(tmp_path, name):
    seed = 2**31 + 12345
    a, ca = _gen(tmp_path, name, seed, "a")
    b, cb = _gen(tmp_path, name, seed, "b")
    c, cc = _gen(tmp_path, name, seed + 1, "c")
    assert ca == cb and ca["n_reads"] == READS[name] == cc["n_reads"]
    for f in ("in.bam", "in.bam.bai", "in.fa", "in.fa.fai"):
        assert filecmp.cmp(a / f, b / f, shallow=False)
    assert not filecmp.cmp(a / "in.bam", c / "in.bam", shallow=False)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_files_read_back(tmp_path, name):
    from longcallr_tpu_torch.io.bai import BaiIndex
    from longcallr_tpu_torch.io.bam import BamFile

    d, counts = _gen(tmp_path, name, 7, "a")
    mine = bamio.BamReader(str(d / "in.bam"))
    theirs = BamFile(str(d / "in.bam"))
    assert len(mine) == counts["n_reads"] == len(theirs)
    for i in (0, len(mine) // 2, len(mine) - 1):
        a, b = mine.read(i), theirs.read(i)
        assert (a.qname, a.pos, a.flag, a.reference_end()) == \
            (b.qname, b.pos, b.flag, b.reference_end())
        assert np.array_equal(a.seq, b.seq) and np.array_equal(a.qual, b.qual)
        assert a.get_tag("de") == b.get_tag("de")
    idx = BaiIndex.load(str(d / "in.bam.bai"))
    assert idx is not None
    fa = bamio.read_fasta(str(d / "in.fa"))
    with open(d / "in.fa.fai") as f:
        assert [l.split("\t")[0] for l in f] == list(fa)


def test_bai_equals_the_programs(tmp_path):
    """The index the writer makes is the one the program's own indexer
    makes of the same BAM."""
    from longcallr_tpu_torch.io.bai import build_bai

    d, _ = _gen(tmp_path, "genome", 11, "a")
    build_bai(str(d / "in.bam"), str(d / "theirs.bai"))
    assert filecmp.cmp(d / "in.bam.bai", d / "theirs.bai", shallow=False)


def test_layout_seed_keeps_the_positions(tmp_path):
    """With ``layout_seed`` every run seed gives reads at the same places
    (and so the same work), with other bases."""
    gen = manifest.generator("transcripts")
    layout = dict(LAYOUTS["transcripts"], layout_seed=99)
    reads = []
    for seed in (5, 6):
        d = tmp_path / str(seed)
        d.mkdir()
        gen.generate(str(d / "in.bam"), str(d / "in.fa"), seed, **layout)
        reads.append(list(bamio.BamReader(str(d / "in.bam"))))
    a, b = reads
    assert [(r.ref_id, r.pos, r.qname) for r in a] == [(r.ref_id, r.pos, r.qname) for r in b]
    assert any(not np.array_equal(x.seq, y.seq) for x, y in zip(a, b))


def test_transcripts_are_spliced_reads_on_both_strands(tmp_path):
    """Introns, insertions, deletions and clips in the CIGARs, genes on both
    strands, and each read's sequence what its CIGAR says it is."""
    d, _ = _gen(tmp_path, "transcripts", 2**31 + 9, "a")
    reads = list(bamio.BamReader(str(d / "in.bam")))
    ops = {bamio.CIGAR_OPS[o] for r in reads for o in r.cigar_ops.tolist()}
    assert {"M", "N", "I", "D", "S"} <= ops
    assert {r.strand for r in reads} == {0, 1}
    for r in reads:
        consumes_seq = np.isin(r.cigar_ops, [0, 1, 4, 7, 8])
        assert int(r.cigar_lens[consumes_seq].sum()) == r.l_seq
        assert r.get_tag("ts") == "+"
