"""Generator ``transcripts``: contigs of isolated diploid genes, each a
spliced transcript (exons and introns) with heterozygous SNPs, and
full-length-style cDNA reads drawn along its isoforms, written as an
indexed BAM and a FASTA.

Locus ``g`` of the sample (counted over contigs) has the transcript length
``tx_lengths[g % len(tx_lengths)]`` and the coverage ``coverages[g %
len(coverages)]``; it gets ``ceil(length * coverage / read_len)`` reads.
Each gene lies on a strand of its own; its reads are oriented along the
transcript (mapped on the gene's strand, ``ts:A:+``). A share of the reads
(``skip_share``) comes from a second isoform that skips one middle exon, so
that SNPs in that exon sit inside an intron of those reads. Reads carry
substitutions, single-base insertions and deletions (CIGAR I, D, never
within ``_EDGE`` bases of a junction or of an end), introns (N) and soft
clips (S) at both ends.

Two seeds draw the sample. ``layout_seed`` draws everything that sets the
work: the exon and intron lengths, the gene strands, the SNPs' places,
reference and alternative bases (every substitution, A>G and T>C included,
so that the RNA-editing filter sees its sites), each read's isoform,
haplotype, start and soft-clip lengths. The run's ``seed`` draws the rest
of the reference, the sequencing errors (substitutions, insertions,
deletions, and their places), the base qualities and the soft-clipped
bases. So every seed does the same work on other bytes.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from harness import bamio

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_EDGE = 12          # no indel this close to a junction or to a read's end
_MARGIN = 2_000     # bases before the first gene of a contig


def _exons(place, length: int, exon_len, intron_len) -> Tuple[List[int], List[int]]:
    """Exon lengths that add up to ``length`` and the introns between them."""
    exons: List[int] = []
    left = length
    while left > 0:
        e = int(place.integers(exon_len[0], exon_len[1] + 1))
        if left - e < exon_len[0]:
            e = left
        exons.append(e)
        left -= e
    introns = [int(place.integers(intron_len[0], intron_len[1] + 1))
               for _ in exons[1:]]
    return exons, introns


def _genome_positions(start: int, exons, introns, skip: int = -1) -> np.ndarray:
    """The genome position of every transcript base, exon ``skip`` left out."""
    parts, cur = [], start
    for k, e in enumerate(exons):
        if k != skip:
            parts.append(np.arange(cur, cur + e, dtype=np.int64))
        cur += e + (introns[k] if k < len(introns) else 0)
    return np.concatenate(parts)


def _read(gpos: np.ndarray, hap: np.ndarray, sub: np.ndarray,
          indel: np.ndarray, extra: np.ndarray, ins_rate: float,
          del_rate: float):
    """(sequence, CIGAR without clips) of a read along ``gpos``, with the
    run's errors: ``sub`` the substituted bases (255 where none), ``indel``
    uniform draws (a deletion below ``del_rate``, an insertion below
    ``del_rate + ins_rate``), ``extra`` the bases of insertions."""
    n = len(gpos)
    seq = hap[gpos]
    errs = sub[:n] != 255
    seq[errs] = sub[:n][errs]
    # transcript offsets where a junction starts the next exon
    junctions = (np.flatnonzero(np.diff(gpos) > 1) + 1).tolist()
    edges = np.array([0, n] + junctions)
    events = []                         # (offset, "D" | "I")
    for o in np.flatnonzero(indel[:n] < del_rate + ins_rate).tolist():
        if np.abs(edges - o).min() >= _EDGE and all(
                abs(o - p) >= _EDGE for p, _ in events):
            events.append((o, "D" if indel[o] < del_rate else "I"))
    cuts = sorted([(j, "N") for j in junctions] + events)
    cigar, parts, prev = [], [], 0
    for o, kind in cuts:
        if o > prev:
            cigar.append((o - prev, "M"))
            parts.append(seq[prev:o])
        if kind == "N":
            cigar.append((int(gpos[o] - gpos[o - 1] - 1), "N"))
            prev = o
        elif kind == "D":
            cigar.append((1, "D"))
            prev = o + 1
        else:
            cigar.append((1, "I"))
            parts.append(extra[o:o + 1])
            prev = o
    cigar.append((n - prev, "M"))
    parts.append(seq[prev:])
    return np.concatenate(parts), cigar


def _contig(args) -> Tuple[str, bytes, List[Tuple[int, int, bytes]]]:
    """(name, reference, records as (position, end, bytes) in coordinate
    order) of contig ``tid``, from its own streams of both seeds."""
    (tid, seed, layout_seed, loci_per_contig, tx_lengths, coverages,
     snp_spacing, read_len, exon_len, intron_len, skip_share, softclip,
     sub_rate, ins_rate, del_rate, qual, gap) = args
    rng = np.random.default_rng(np.random.SeedSequence([seed, tid]))
    place = np.random.default_rng(np.random.SeedSequence([layout_seed, tid]))
    tags = bamio.tag_bytes("de", "f", sub_rate + ins_rate + del_rate) \
        + bamio.tag_bytes("ts", "A", "+")
    genes = []
    cur = _MARGIN
    for i in range(loci_per_contig):
        g = tid * loci_per_contig + i
        length = int(tx_lengths[g % len(tx_lengths)])
        cov = int(coverages[g % len(coverages)])
        exons, introns = _exons(place, length, exon_len, intron_len)
        genes.append((cur, length, cov, exons, introns,
                      int(place.integers(0, 2))))
        cur += length + sum(introns) + gap
    ref = _BASES[rng.integers(0, 4, size=cur)]
    hap1 = ref.copy()
    for start, length, cov, exons, introns, minus in genes:
        gpos = _genome_positions(start, exons, introns)
        offs = np.arange(200, length - 200, snp_spacing)
        offs = offs + place.integers(0, max(1, snp_spacing // 4), size=len(offs))
        sites = gpos[offs]
        r = place.integers(0, 4, size=len(sites))
        ref[sites] = _BASES[r]
        hap1[sites] = _BASES[(r + place.integers(1, 4, size=len(sites))) % 4]
    haps = (hap1, ref)
    records = []
    cnt = 0
    for start, length, cov, exons, introns, minus in genes:
        isoforms = [_genome_positions(start, exons, introns)]
        if len(exons) >= 3:
            isoforms.append(_genome_positions(
                start, exons, introns, int(place.integers(1, len(exons) - 1))))
        n = int(np.ceil(length * cov / read_len))
        iso = (place.random(n) < skip_share) & (len(isoforms) > 1)
        hap = place.integers(0, 2, size=n)
        u = place.random(n)
        clips = place.integers(softclip[0], softclip[1] + 1, size=(n, 2))
        # the run's draws for every read of the gene at once
        sub = np.where(rng.random((n, read_len)) < sub_rate,
                       _BASES[rng.integers(0, 4, size=(n, read_len))], 255
                       ).astype(np.uint8)
        indel = rng.random((n, read_len))
        extra = _BASES[rng.integers(0, 4, size=(n, read_len))]
        clip_bases = _BASES[rng.integers(0, 4, size=(n, 2 * softclip[1]))]
        # the longest read: clips at both ends, an insertion every _EDGE bases
        longest = read_len + 2 * softclip[1] + read_len // _EDGE + 1
        quals = rng.integers(qual[0], qual[1], size=(n, longest)).astype(np.uint8)
        for k in range(n):
            gp = isoforms[int(iso[k])]
            rl = min(read_len, len(gp))
            t0 = int(u[k] * (len(gp) - rl + 1))
            seq, cigar = _read(gp[t0:t0 + rl], haps[hap[k]], sub[k], indel[k],
                               extra[k], ins_rate, del_rate)
            c0, c1 = int(clips[k, 0]), int(clips[k, 1])
            if c0 or c1:
                seq = np.concatenate([clip_bases[k, :c0], seq,
                                      clip_bases[k, softclip[1]:softclip[1] + c1]])
                cigar = ([(c0, "S")] if c0 else []) + cigar \
                    + ([(c1, "S")] if c1 else [])
            pos = int(gp[t0])
            end, rec = bamio.encode(tid, pos, f"t{tid}_{cnt:06d}",
                                    16 if minus else 0, seq, quals[k, :len(seq)],
                                    tags, cigar=cigar)
            records.append((pos, end, rec))
            cnt += 1
    records.sort(key=lambda t: t[0])
    return f"chrT{tid}", bytes(ref), records


def generate(bam_path: str, fasta_path: str, seed: int, n_contigs: int,
             loci_per_contig: int, tx_lengths, coverages, snp_spacing: int,
             read_len: int, exon_len=(150, 700), intron_len=(200, 1500),
             skip_share: float = 0.2, softclip=(0, 30), sub_rate: float = 0.001,
             ins_rate: float = 0.0005, del_rate: float = 0.0005,
             qual=(25, 31), gap: int = 40_000, layout_seed: int = 0) -> Dict:
    """Writes the sample; the contigs are drawn in worker processes, each
    from streams of its own, so the files do not depend on the workers."""
    jobs = [(tid, seed, layout_seed, loci_per_contig, tx_lengths, coverages,
             snp_spacing, read_len, exon_len, intron_len, skip_share, softclip,
             sub_rate, ins_rate, del_rate, qual, gap) for tid in range(n_contigs)]
    workers = min(n_contigs, os.cpu_count() or 1)
    if workers > 1:
        ctx = multiprocessing.get_context("fork")
        with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
            contigs = list(ex.map(_contig, jobs))
    else:
        contigs = [_contig(j) for j in jobs]
    w = bamio.BamWriter(bam_path, [c[0] for c in contigs],
                        [len(c[1]) for c in contigs])
    for tid, (_, _, records) in enumerate(contigs):
        for pos, end, rec in records:
            w.add(tid, pos, end, rec)
    w.close(index=True)
    bamio.write_fasta(fasta_path, {name: ref for name, ref, _ in contigs})
    return {"n_reads": sum(len(c[2]) for c in contigs),
            "n_snps": sum(len(range(200, int(tx_lengths[g % len(tx_lengths)]) - 200,
                                    snp_spacing))
                          for g in range(n_contigs * loci_per_contig))}
