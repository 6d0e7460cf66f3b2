"""VCF emission and input-candidate loading.

Emission mirrors ``longcallR/src/vcf.rs:27-306`` (output_phased_vcf) and the
header/serialisation in ``src/thread.rs:224-305`` byte-for-byte: the same
FILTER/INFO/FORMAT branches, ``{:.2}`` float formatting, and ``as i32``
truncation of QUAL/GQ. One deliberate deviation: the reference appends
records in rayon completion order (nondeterministic across runs,
thread.rs:215-221); we emit regions in deterministic (contig, start) order.

The input-candidate loader replaces ``get_genotype_quality_phase_from_vcf``
(vcf.rs:400-462, rust-htslib bcf) with a text VCF parser (plain or bgzf)
plus a BCF2 binary decoder (``load_bcf_candidates``); the format is
detected from file content, not the extension.

Copied from ``longcallr_tpu/io/vcf.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, TextIO, Tuple

import numpy as np

from .bgzf import decompress_file

VCF_HEADER_LINES = [
    "##fileformat=VCFv4.3",
]

_FILTER_META = [
    '##FILTER=<ID=PASS,Description="All filters passed">',
    '##FILTER=<ID=LowQual,Description="Low phasing quality">',
    '##FILTER=<ID=HomRef,Description="Homo reference">',
    '##FILTER=<ID=RnaEdit,Description="RNA editing">',
    '##FILTER=<ID=Multiallelic,Description="Multiallelic SNP">',
    '##FILTER=<ID=dn,Description="Dense cluster of variants">',
    '##INFO=<ID=RDS,Number=1,Type=String,Description="RNA editing or Dense SNP or Single SNP.">',
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
    '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase Set">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype Quality">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read Depth">',
    '##FORMAT=<ID=AF,Number=A,Type=Float,Description="Allele Frequency">',
    '##FORMAT=<ID=PQ,Number=1,Type=Float,Description="Phasing Quality">',
    '##FORMAT=<ID=AE,Number=A,Type=Integer,Description="Haplotype expression of two alleles">',
    '##FORMAT=<ID=SQ,Number=1,Type=Float,Description="Somatic Score">',
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSample",
]


def write_vcf_header(f: TextIO, contig_lengths: Sequence[Tuple[str, int]]) -> None:
    """thread.rs:224-263."""
    f.write("##fileformat=VCFv4.3\n")
    for chrom, ln in contig_lengths:
        f.write(f"##contig=<ID={chrom},length={ln}>\n")
    f.write("\n".join(_FILTER_META) + "\n")


def _as_i32(x: float) -> int:
    """Rust `as i32`: truncation toward zero, saturating (inf → i32::MAX)."""
    if math.isnan(x):
        return 0
    if x >= 2147483647.0:
        return 2147483647
    if x <= -2147483648.0:
        return -2147483648
    return int(x)


def _f2(x) -> str:
    """Rust `{:.2}` formatting."""
    return f"{float(x):.2f}"


def format_region_records(cands, min_phase_score: float) -> List[str]:
    """output_phased_vcf (vcf.rs:27-306) for one region's CandidateSet.

    Returns complete tab-joined VCF data lines. Records that end up with no
    ALT allele are dropped, mirroring the writer loop (thread.rs:265-304)
    which only serialises records with 1 or 2 alternatives.
    """
    out_lines: List[str] = []

    def emit(fields):
        if fields[4]:  # non-empty ALT
            out_lines.append("\t".join(fields))

    n = cands.n
    for i in range(n):
        chrom = cands.chrom
        pos1 = int(cands.pos[i]) + 1
        refb = chr(cands.ref_base[i])
        a1 = chr(cands.alleles[i, 0])
        a2 = chr(cands.alleles[i, 1])
        f1 = cands.allele_freqs[i, 0]
        f2 = cands.allele_freqs[i, 1]
        vt = int(cands.variant_type[i])
        geno = int(cands.genotype[i])
        qual = _as_i32(float(cands.variant_quality[i]))
        gq = _as_i32(float(cands.genotype_quality[i]))
        depth = int(cands.depth[i])
        ps = float(cands.phase_score[i])
        pset = int(cands.phase_set[i])

        def alt_single():
            if a1 != refb:
                return a1, f1
            if a2 != refb:
                return a2, f2
            return "", 0.0

        if cands.dense[i]:
            # FILTER=dn branch (vcf.rs:31-78)
            if vt in (1, 2):
                alt, af0 = alt_single()
                alt_field = alt
            elif vt == 3:
                alt_field = f"{a1},{a2}"
                af0, af1 = f1, f2
            else:
                alt_field = ""
            if vt == 1:
                gt = "0/1"
            elif vt == 2:
                gt = "1/1"
            elif vt == 3:
                gt = "1/2"
            else:
                continue
            if vt == 3:
                sample = f"{gt}:{gq}:{depth}:{_f2(af0)},{_f2(af1)}"
            else:
                sample = f"{gt}:{gq}:{depth}:{_f2(af0)}"
            emit([chrom, str(pos1), ".", refb, alt_field,
                  str(qual), "dn", "RDS=dense_snp", "GT:GQ:DP:AF", sample])
            continue

        if cands.non_selected[i]:
            # RDS=noselect branch (vcf.rs:80-174)
            if cands.rna_editing[i]:
                if vt in (1, 2):
                    alt, af0 = alt_single()
                else:
                    continue
                gt = "0/1" if vt == 1 else ("1/1" if vt == 2 else "0/0")
                sample = f"{gt}:{gq}:{depth}:{_f2(af0)}"
                emit([chrom, str(pos1), ".", refb, alt,
                      str(qual), "RnaEdit", "RDS=noselect",
                      "GT:GQ:DP:AF", sample])
                continue
            if vt in (0, 1, 2):
                alt, af0 = alt_single()
                if vt == 0:
                    gt, filt = "0/0", "HomRef"
                elif vt == 1:
                    gt, filt = "0/1", "LowQual"
                else:
                    gt, filt = "1/1", "PASS"
                alt_field = alt
                two = False
            else:
                if geno in (-1, 1):
                    alt, af0 = alt_single()
                    alt_field = alt
                    gt, filt = ("1/1", "PASS") if geno == -1 else ("0/0", "HomRef")
                    two = False
                elif geno == 0:
                    alt_field = f"{a1},{a2}"
                    af0, af1 = f1, f2
                    gt, filt = "1/2", "Multiallelic"
                    two = True
                else:
                    alt_field, gt, filt, af0, two = "", "0/0", "", 0.0, False
            if two:
                sample = f"{gt}:{gq}:{depth}:{_f2(af0)},{_f2(af1)}"
            else:
                sample = f"{gt}:{gq}:{depth}:{_f2(af0)}"
            emit([chrom, str(pos1), ".", refb, alt_field,
                  str(qual), filt, "RDS=noselect", "GT:GQ:DP:AF", sample])
            continue

        # selected branch, RDS=select (vcf.rs:175-303)
        gt = "0/0"
        filt = ""
        alt_field = ""
        af0 = af1 = 0.0
        two = False
        if ps >= min_phase_score:
            if vt == 1:
                alt_field, af0 = alt_single()
                gt = "0|1" if int(cands.haplotype[i]) == 1 else "1|0"
                filt = "PASS"
        else:
            if vt == 0:
                alt_field, af0 = alt_single()
                gt, filt = "0/0", "HomRef"
            elif vt == 1:
                alt_field, af0 = alt_single()
                gt, filt = "0/1", "LowQual"
            elif vt == 2:
                alt_field, af0 = alt_single()
                gt, filt = "1/1", "PASS"
            else:
                if geno in (-1, 1):
                    alt_field, af0 = alt_single()
                    gt, filt = ("1/1", "PASS") if geno == -1 else ("0/0", "HomRef")
                elif geno == 0:
                    alt_field = f"{a1},{a2}"
                    af0, af1 = f1, f2
                    gt, filt = "1/2", "Multiallelic"
                    two = True
        ps_field = str(pset) if pset != 0 else "."
        if gt in ("0/0", "0/1", "1/1", "0|1", "1|0"):
            sample = f"{gt}:{gq}:{ps_field}:{depth}:{_f2(af0)}:{_f2(ps)}"
        else:
            sample = f"{gt}:{gq}:{ps_field}:{depth}:{_f2(af0)},{_f2(af1)}:{_f2(ps)}"
        emit([chrom, str(pos1), ".", refb, alt_field,
              str(qual), filt, "RDS=select", "GT:GQ:PS:DP:AF:PQ", sample])
    return out_lines


@dataclass
class GenotypeAndQuality:
    genotype: int  # 0: 0/0, 1: 0/1, 2: 1/1, 3: 1/2, 4: other
    quality: float
    phased: bool


def _gt_pair_code(g0: int, g1: int) -> int:
    """Genotype pair → reference code (vcf.rs:418-447): 0/0→0, 0/1→1,
    1/1→2, 1/2→3, anything else (incl. missing alleles) → 4; missing
    allele is treated as '3' first, like the text path's '.'→3."""
    pair = (g0, g1)
    if pair == (0, 0):
        return 0
    if pair in ((0, 1), (1, 0)):
        return 1
    if pair == (1, 1):
        return 2
    if pair in ((1, 2), (2, 1)):
        return 3
    return 4


# BCF2 typed-value descriptors (hts-specs BCFv2.2 §6.3.3)
_BCF_TYPE_SIZE = {1: 1, 2: 2, 3: 4, 5: 4, 7: 1}
_BCF_MISSING_QUAL = 0x7F800001  # bit pattern of the "missing" float


def _bcf_typed_head(buf: bytes, o: int) -> Tuple[int, int, int]:
    """Decode one type descriptor at offset o → (type, length, next_off)."""
    b = buf[o]
    o += 1
    t = b & 0x0F
    ln = b >> 4
    if ln == 15:  # overflow: length follows as a typed int
        t2, ln2, o = _bcf_typed_head(buf, o)
        ln = _bcf_int(buf, o, t2)
        o += _BCF_TYPE_SIZE[t2] * ln2
    return t, ln, o


def _bcf_int(buf: bytes, o: int, t: int) -> int:
    import struct
    if t == 1:
        return struct.unpack_from("<b", buf, o)[0]
    if t == 2:
        return struct.unpack_from("<h", buf, o)[0]
    if t == 3:
        return struct.unpack_from("<i", buf, o)[0]
    raise ValueError(f"BCF: unexpected int type {t}")


def _bcf_skip_typed(buf: bytes, o: int) -> int:
    t, ln, o = _bcf_typed_head(buf, o)
    return o + (_BCF_TYPE_SIZE[t] * ln if t != 0 else 0)


def _bcf_header_dicts(header: str) -> Tuple[Dict[int, str], Dict[int, str]]:
    """Build the (string dictionary, contig dictionary) from the embedded
    VCF header text: IDX= wins, else order of first appearance; PASS is
    implicitly string index 0 (hts-specs §6.2.1)."""
    import re
    strings: Dict[int, str] = {}
    contigs: Dict[int, str] = {}
    seen: Dict[str, int] = {}
    next_idx = 0

    def add_string(name: str, idx: Optional[int]) -> None:
        nonlocal next_idx
        if name in seen:
            return
        if idx is None:
            idx = next_idx
        seen[name] = idx
        strings[idx] = name
        next_idx = max(next_idx, idx + 1)

    add_string("PASS", 0)
    n_ctg = 0
    for line in header.splitlines():
        m = re.match(r"##(FILTER|INFO|FORMAT|contig)=<(.*)>\s*$", line)
        if not m:
            continue
        kind, body = m.group(1), m.group(2)
        mid = re.search(r"(?:^|,)ID=([^,>]+)", body)
        if not mid:
            continue
        midx = re.search(r"(?:^|,)IDX=(\d+)", body)
        idx = int(midx.group(1)) if midx else None
        if kind == "contig":
            contigs[idx if idx is not None else n_ctg] = mid.group(1)
            n_ctg += 1
        else:
            add_string(mid.group(1), idx)
    return strings, contigs


def load_bcf_candidates(data: bytes) -> Dict[str, Dict[int, GenotypeAndQuality]]:
    """Decode a BCF2 stream (already BGZF-decompressed) into the same
    chr → pos → GenotypeAndQuality map as the text path — the binary half
    of get_genotype_quality_phase_from_vcf (vcf.rs:400-462, rust-htslib
    accepts both)."""
    import struct
    if data[:3] != b"BCF":
        raise ValueError("not a BCF stream")
    if data[3] != 2:
        raise ValueError(f"unsupported BCF major version {data[3]}")
    l_text = struct.unpack_from("<I", data, 5)[0]
    header = data[9:9 + l_text].split(b"\x00", 1)[0].decode()
    strings, contigs = _bcf_header_dicts(header)
    gt_keys = {i for i, s in strings.items() if s == "GT"}
    out: Dict[str, Dict[int, GenotypeAndQuality]] = {}
    o = 9 + l_text
    n = len(data)
    while o + 8 <= n:
        l_shared, l_indiv = struct.unpack_from("<II", data, o)
        rec_end = o + 8 + l_shared + l_indiv
        s = o + 8
        rid, pos0 = struct.unpack_from("<ii", data, s)
        (qual_bits,) = struct.unpack_from("<I", data, s + 12)
        # missing QUAL propagates as NaN, like rust-htslib's record.qual():
        # the import gate `quality < min_variant_qual` (candidate.rs:550) is
        # then false → record KEPT, and emission casts NaN `as i32` → 0
        # (_as_i32), matching the reference byte-for-byte.
        qual = (float("nan") if qual_bits == _BCF_MISSING_QUAL
                else struct.unpack_from("<f", data, s + 12)[0])
        n_allele_info, n_fmt_sample = struct.unpack_from("<II", data, s + 16)
        n_info = n_allele_info & 0xFFFF
        n_allele = n_allele_info >> 16
        n_sample = n_fmt_sample & 0xFFFFFF
        n_fmt = n_fmt_sample >> 24
        p = s + 24
        p = _bcf_skip_typed(data, p)            # ID
        for _ in range(n_allele):               # REF + ALTs
            p = _bcf_skip_typed(data, p)
        p = _bcf_skip_typed(data, p)            # FILTER
        for _ in range(n_info):                 # INFO k/v pairs
            p = _bcf_skip_typed(data, p)
            p = _bcf_skip_typed(data, p)
        # indiv block: n_fmt × (typed key, per-sample typed vector)
        p = o + 8 + l_shared
        for _ in range(n_fmt):
            tk, lk, p = _bcf_typed_head(data, p)
            key = _bcf_int(data, p, tk)
            p += _BCF_TYPE_SIZE[tk] * lk
            tv, lv, p = _bcf_typed_head(data, p)
            width = _BCF_TYPE_SIZE.get(tv, 0) * lv
            if key in gt_keys and n_sample >= 1 and tv in (1, 2, 3):
                # ALL samples, last-valid-wins insert; `phased` is sticky
                # across the record's samples and derives from the second
                # allele's phase bit only (vcf.rs:414-455 loops
                # 0..sample_count with a record-scoped `phased`)
                phased = False
                eov = {1: -127, 2: -32767, 3: -2147483647}[tv]
                for sj in range(n_sample):
                    base = p + sj * width
                    vals = [_bcf_int(data, base + j * _BCF_TYPE_SIZE[tv], tv)
                            for j in range(lv)]
                    # drop END_OF_VECTOR padding (0x80+1 for int8 etc.)
                    vals = [v for v in vals if v != eov]
                    if len(vals) != 2:
                        continue
                    phased = phased or bool(vals[1] & 1)
                    al = [((v >> 1) - 1) if v > 0 else 3 for v in vals]
                    code = _gt_pair_code(al[0], al[1])
                    chrom = contigs.get(rid, str(rid))
                    out.setdefault(chrom, {})[pos0] = GenotypeAndQuality(
                        code, float(qual), phased)
            p += width * n_sample
        o = rec_end
    return out


def load_input_candidates(vcf_path: str) -> Dict[str, Dict[int, GenotypeAndQuality]]:
    """get_genotype_quality_phase_from_vcf (vcf.rs:400-462): chr → 0-based
    pos → genotype code + quality. Accepts text VCF (plain or bgzipped)
    and binary BCF2 — format detected from content, not extension."""
    with open(vcf_path, "rb") as f:
        head = f.read(4)
    if head[:2] == b"\x1f\x8b":
        data = decompress_file(vcf_path)
        if data[:3] == b"BCF":
            return load_bcf_candidates(data)
        text = data.decode()
    elif head[:3] == b"BCF":
        with open(vcf_path, "rb") as f:
            return load_bcf_candidates(f.read())
    else:
        text = open(vcf_path).read()
    out: Dict[str, Dict[int, GenotypeAndQuality]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        if len(parts) < 10:
            continue
        chrom = parts[0]
        pos0 = int(parts[1]) - 1
        try:
            # '.' (missing) → NaN, as htslib's text parser yields the
            # missing-float for rust-htslib's record.qual(); keeps the
            # import gate and the NaN-as-i32 emission identical to BCF
            qual = float("nan") if parts[5] == "." else float(parts[5])
        except ValueError:
            qual = 0.0
        fmt = parts[8].split(":")
        try:
            gt_idx = fmt.index("GT")
        except ValueError:
            continue
        # ALL sample columns, last-valid-wins insert, record-sticky `phased`
        # (vcf.rs:414-455; the separator before the second allele is the
        # per-sample phase flag)
        phased = False
        for col in parts[9:]:
            gt = col.split(":")[gt_idx]
            al = gt.replace("|", "/").split("/")
            if len(al) != 2:
                continue
            try:
                g0 = 3 if al[0] == "." else int(al[0])
                g1 = 3 if al[1] == "." else int(al[1])
            except ValueError:
                continue
            phased = phased or "|" in gt
            code = _gt_pair_code(g0, g1)
            out.setdefault(chrom, {})[pos0] = GenotypeAndQuality(
                code, qual, phased)
    return out
