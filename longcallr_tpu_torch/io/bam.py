"""BAM container reader/writer (pure Python + numpy; no htslib).

Replaces the rust-htslib BAM layer the reference uses
(``longcallR/src/util.rs:636``, ``src/fragment.rs:19``, ``src/thread.rs:326``).
The design keeps the uncompressed BAM image in memory and exposes reads as
lightweight views with lazily decoded seq/qual/cigar; per-record header fields
(refID/pos/flag/mapq/...) are bulk-extracted into numpy arrays during the
initial scan so region grouping and QC filtering are vectorised.

The phased-BAM writer copies raw record bytes and appends aux tags in place,
so round-tripping never re-encodes sequences.

Copied from ``longcallr_tpu/io/bam.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged (one docstring reworded).
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .bgzf import BgzfWriter, decompress_file

BAM_MAGIC = b"BAM\x01"

# CIGAR operation characters, indexed by the 4-bit op code (SAM spec 4.2).
CIGAR_OPS = "MIDNSHP=X"
_OP_M, _OP_I, _OP_D, _OP_N, _OP_S, _OP_H, _OP_P, _OP_EQ, _OP_X = range(9)
# ops that consume reference / query
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)
CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)

# 4-bit encoded base → ASCII (SAM spec: =ACMGRSVTWYHKDBN)
SEQ_NIBBLE_ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
_NIB_HI = SEQ_NIBBLE_ASCII[np.arange(256) >> 4]
_NIB_LO = SEQ_NIBBLE_ASCII[np.arange(256) & 0xF]
# ASCII → 4-bit code for the writer
ASCII_TO_NIBBLE = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    ASCII_TO_NIBBLE[_c] = _i
    ASCII_TO_NIBBLE[_c | 0x20] = _i  # lowercase

FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_QCFAIL = 0x200
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

_FIXED = struct.Struct("<iii2B3H4i")  # block_size + 32-byte fixed record prefix

_AUX_SIZES = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4, "A": 1}
_AUX_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I", "f": "<f"}


def decode_seq(packed: memoryview, l_seq: int) -> np.ndarray:
    """Decode 4-bit packed bases into an ASCII uint8 array."""
    raw = np.frombuffer(packed, dtype=np.uint8)
    out = np.empty(raw.size * 2, dtype=np.uint8)
    out[0::2] = _NIB_HI[raw]
    out[1::2] = _NIB_LO[raw]
    return out[:l_seq]


def _scan_aux(buf: memoryview, start: int, end: int) -> Iterator[Tuple[str, str, int]]:
    """Yield (tag, type, value_offset) for each aux field in buf[start:end)."""
    q = start
    while q + 3 <= end:
        tag = chr(buf[q]) + chr(buf[q + 1])
        typ = chr(buf[q + 2])
        q += 3
        yield tag, typ, q
        if typ in _AUX_SIZES:
            q += _AUX_SIZES[typ]
        elif typ in "ZH":
            while q < end and buf[q] != 0:
                q += 1
            q += 1
        elif typ == "B":
            st = chr(buf[q])
            cnt = struct.unpack_from("<i", buf, q + 1)[0]
            q += 5 + cnt * _AUX_SIZES[st]
        else:
            raise ValueError(f"unknown aux type {typ!r}")


class BamRead:
    """Lazy view over one alignment record inside the uncompressed BAM image."""

    __slots__ = ("_buf", "_off", "_end", "ref_id", "pos", "flag", "mapq",
                 "l_seq", "_n_cigar", "_l_read_name")

    def __init__(self, buf: memoryview, off: int, end: int, ref_id: int, pos: int,
                 flag: int, mapq: int, l_seq: int, n_cigar: int, l_read_name: int):
        self._buf = buf
        self._off = off          # offset of the fixed 32-byte record prefix
        self._end = end          # one past the last aux byte
        self.ref_id = ref_id
        self.pos = pos
        self.flag = flag
        self.mapq = mapq
        self.l_seq = l_seq
        self._n_cigar = n_cigar
        self._l_read_name = l_read_name

    # --- layout offsets ---
    @property
    def _name_off(self) -> int:
        return self._off + 32

    @property
    def _cigar_off(self) -> int:
        return self._name_off + self._l_read_name

    @property
    def _seq_off(self) -> int:
        return self._cigar_off + 4 * self._n_cigar

    @property
    def _qual_off(self) -> int:
        return self._seq_off + (self.l_seq + 1) // 2

    @property
    def _aux_off(self) -> int:
        return self._qual_off + self.l_seq

    # --- decoded fields ---
    @property
    def qname(self) -> str:
        return bytes(self._buf[self._name_off:self._name_off + self._l_read_name - 1]).decode()

    @property
    def cigar(self) -> np.ndarray:
        """uint32 cigar words (len<<4 | op).

        CIGARs with more than 65,535 ops don't fit the record's 16-bit
        n_cigar field: BAM stores a two-op ``kSmN`` placeholder (k = l_seq,
        m = reference span) and the real cigar in a ``CG:B,I`` aux array.
        htslib reconstructs this transparently, so the reference (via
        rust-htslib, Cargo.toml:13) sees the real cigar — replicate that.
        The record layout (seq/qual/aux offsets) still uses the raw
        two-word field, and raw passthrough keeps the original bytes."""
        raw = np.frombuffer(self._buf[self._cigar_off:self._seq_off],
                            dtype="<u4")
        if (self._n_cigar == 2 and raw.size == 2
                and int(raw[0]) == ((self.l_seq << 4) | _OP_S)
                and (int(raw[1]) & 0xF) == _OP_N):
            cg = self.get_tag("CG")
            if cg is not None and getattr(cg, "size", 0) > 0 \
                    and cg.dtype == np.uint32:
                return cg
        return raw

    @property
    def cigar_ops(self) -> np.ndarray:
        return (self.cigar & 0xF).astype(np.uint8)

    @property
    def cigar_lens(self) -> np.ndarray:
        return (self.cigar >> 4).astype(np.int64)

    @property
    def seq(self) -> np.ndarray:
        """ASCII uint8 base array."""
        return decode_seq(self._buf[self._seq_off:self._qual_off], self.l_seq)

    @property
    def qual(self) -> np.ndarray:
        return np.frombuffer(self._buf[self._qual_off:self._aux_off], dtype=np.uint8)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def strand(self) -> int:
        """0 = forward, 1 = reverse (matches reference util.rs:672)."""
        return 1 if self.flag & FLAG_REVERSE else 0

    def reference_end(self) -> int:
        """0-based exclusive end on the reference."""
        ops = self.cigar_ops
        lens = self.cigar_lens
        return self.pos + int(lens[CONSUMES_REF[ops]].sum())

    def leading_softclips(self) -> int:
        c = self.cigar
        if c.size == 0:
            return 0
        # hard clips precede soft clips; scan from the front
        for w in c:
            op = w & 0xF
            if op == _OP_H:
                continue
            return int(w >> 4) if op == _OP_S else 0
        return 0

    def trailing_softclips(self) -> int:
        c = self.cigar
        if c.size == 0:
            return 0
        for w in c[::-1]:
            op = w & 0xF
            if op == _OP_H:
                continue
            return int(w >> 4) if op == _OP_S else 0
        return 0

    def get_tag(self, name: str):
        """Return decoded aux tag value or None."""
        buf = self._buf
        for tag, typ, voff in _scan_aux(buf, self._aux_off, self._end):
            if tag != name:
                continue
            if typ in _AUX_FMT:
                return struct.unpack_from(_AUX_FMT[typ], buf, voff)[0]
            if typ == "A":
                return chr(buf[voff])
            if typ in "ZH":
                q = voff
                while buf[q] != 0:
                    q += 1
                return bytes(buf[voff:q]).decode()
            if typ == "B":
                st = chr(buf[voff])
                cnt = struct.unpack_from("<i", buf, voff + 1)[0]
                dt = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
                      "i": "<i4", "I": "<u4", "f": "<f4"}[st]
                return np.frombuffer(buf[voff + 5:voff + 5 + cnt * _AUX_SIZES[st]], dtype=dt)
            return None
        return None

    def tags(self) -> Dict[str, object]:
        return {tag: self.get_tag(tag) for tag, _, _ in
                _scan_aux(self._buf, self._aux_off, self._end)}

    def raw_record(self) -> bytes:
        """Record bytes (without the leading block_size word)."""
        return bytes(self._buf[self._off:self._end])

    def aux_bytes(self) -> bytes:
        """Raw aux-field bytes of the record."""
        return bytes(self._buf[self._aux_off:self._end])


class BamFile:
    """An indexed-in-memory BAM file.

    The constructor decompresses the whole BGZF stream and bulk-scans record
    boundaries, producing numpy columns (ref_id, pos, flag, mapq, l_seq) used
    for vectorised filtering and region grouping.
    """

    def __init__(self, path: str, threads: int = 4,
                 region: Optional[Tuple[str, int, int]] = None,
                 bai_path: Optional[str] = None):
        """``region=(chrom, start0, end0)`` + a ``.bai`` beside the BAM (or at
        ``bai_path``) loads ONLY the BGZF blocks covering that window (the
        rust-htslib IndexedReader.fetch analog, util.rs:560-613); without an
        index, or without ``region``, the whole stream is loaded."""
        import os

        self.path = path
        if region is not None:
            bp = bai_path or path + ".bai"
            if os.path.exists(bp) and self._load_window(path, threads,
                                                        region, bp):
                return
        data = decompress_file(path, threads=threads)
        p = self._parse_header(data)
        self._set_data(data)
        self._records_start = p
        self._scan_records(p)

    def _set_data(self, data: bytes) -> None:
        self._data = data
        self._buf = memoryview(data)

    def _parse_header(self, data: bytes) -> int:
        """Parse magic/text/references; returns the records-start offset.
        Raises IndexError/struct.error on a truncated prefix (the windowed
        loader grows its read until this succeeds)."""
        if data[:4] != BAM_MAGIC:
            raise ValueError(f"{self.path}: not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        if len(data) < 8 + l_text + 4:
            raise IndexError("truncated header")
        self.header_text = data[8:8 + l_text].rstrip(b"\x00").decode()
        p = 8 + l_text
        n_ref = struct.unpack_from("<i", data, p)[0]
        p += 4
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, p)[0]
            p += 4
            if len(data) < p + l_name + 4:
                raise IndexError("truncated header")
            self.references.append(data[p:p + l_name - 1].decode())
            p += l_name
            self.lengths.append(struct.unpack_from("<i", data, p)[0])
            p += 4
        self._ref_index = {name: i for i, name in enumerate(self.references)}
        return p

    def _load_window(self, path: str, threads: int,
                     region: Tuple[str, int, int], bai_path: str) -> bool:
        """BAI-indexed windowed load; returns False to fall back to a full
        load (e.g. unparsable index)."""
        from .bai import BaiIndex
        from .bgzf import (MAX_BLOCK_SIZE, BgzfError, BgzfTruncated,
                           _block_size_at, decompress_blocks)

        try:
            bai = BaiIndex.load(bai_path)
        except (ValueError, OSError):
            return False
        with open(path, "rb") as f:
            # header: grow the raw prefix until it parses (rarely >64 KiB)
            raw = b""
            need = 1 << 16
            while True:
                more = f.read(need - len(raw))
                raw += more
                spans = []
                off = 0
                try:
                    while off < len(raw):
                        b = _block_size_at(raw, off)
                        if off + b > len(raw):
                            break
                        spans.append((off, b))
                        off += b
                except BgzfTruncated:
                    pass       # prefix cut mid-header: the grow loop below
                               # fetches more; not a malformed file
                except BgzfError:
                    return False
                head = decompress_blocks(raw, spans, threads=threads)
                try:
                    hdr_end = self._parse_header(head)
                    break
                except (IndexError, struct.error):
                    if not more and off + MAX_BLOCK_SIZE > len(raw):
                        return False
                    need *= 2
            chrom, start0, end0 = region
            tid = self._ref_index.get(chrom)
            span = None if tid is None else bai.chunk_span(tid, start0, end0)
            if span is None:                      # no records in window
                self._set_data(head[:hdr_end])
                self._records_start = hdr_end
                self._scan_records(hdr_end)
                return True
            cbeg, cend = span
            c0, c1 = cbeg >> 16, cend >> 16
            f.seek(c0)
            raw = f.read(c1 - c0 + MAX_BLOCK_SIZE)
        spans = []
        ustarts = []
        off, total = 0, 0
        while off <= c1 - c0 and off < len(raw):
            try:
                b = _block_size_at(raw, off)
            except BgzfTruncated:
                break          # window read ends mid-header (file tail)
            if off + b > len(raw):
                break
            spans.append((off, b))
            ustarts.append(total)
            total += struct.unpack_from("<I", raw, off + b - 4)[0]
            off += b
        out = decompress_blocks(raw, spans, threads=threads)
        tail = len(out)
        j = next((j for j, (o, _) in enumerate(spans) if o == c1 - c0), None)
        if j is not None:                         # cut inside cend's block
            tail = ustarts[j] + (cend & 0xFFFF)
        self._set_data(out[(cbeg & 0xFFFF):tail])
        self._records_start = 0
        self._scan_records(0)
        return True

    def _scan_records(self, p: int) -> None:
        data = self._data
        n = len(data)
        if self._scan_records_native(p, n):
            return
        offs: List[int] = []
        ends: List[int] = []
        ref_ids: List[int] = []
        poss: List[int] = []
        flags: List[int] = []
        mapqs: List[int] = []
        lseqs: List[int] = []
        ncigs: List[int] = []
        lnames: List[int] = []
        unpack = _FIXED.unpack_from
        while p + 36 <= n:    # 4-byte block_size + 32-byte fixed prefix
            (block_size, ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
             l_seq, _nref, _npos, _tlen) = unpack(data, p)
            rec_off = p + 4
            if rec_off + block_size > n:          # truncated tail record
                break
            offs.append(rec_off)
            ends.append(rec_off + block_size)
            ref_ids.append(ref_id)
            poss.append(pos)
            flags.append(flag)
            mapqs.append(mapq)
            lseqs.append(l_seq)
            ncigs.append(n_cigar)
            lnames.append(l_read_name)
            p = rec_off + block_size
        self.n_records = len(offs)
        self.rec_off = np.asarray(offs, dtype=np.int64)
        self.rec_end = np.asarray(ends, dtype=np.int64)
        self.ref_id = np.asarray(ref_ids, dtype=np.int32)
        self.pos = np.asarray(poss, dtype=np.int64)
        self.flag = np.asarray(flags, dtype=np.uint16)
        self.mapq = np.asarray(mapqs, dtype=np.uint8)
        self.l_seq = np.asarray(lseqs, dtype=np.int32)
        self.n_cigar = np.asarray(ncigs, dtype=np.int32)
        self.l_read_name = np.asarray(lnames, dtype=np.int32)
        ref_end_col = np.empty(self.n_records, np.int64)
        de_col = np.full(self.n_records, np.nan, np.float32)
        for i in range(self.n_records):
            r = self.read(i)
            ref_end_col[i] = r.reference_end()
            de = r.get_tag("de")
            if isinstance(de, float):
                de_col[i] = de
        self.ref_end = ref_end_col
        self.de = de_col

    def _scan_records_native(self, p: int, n: int) -> bool:
        try:
            from .. import native
            nlib = native.lib()
        except Exception:
            return False
        if nlib is None:
            return False
        import ctypes
        cap = max(16, (n - p) // 36 + 1)
        rec_off = np.empty(cap, np.int64)
        rec_end = np.empty(cap, np.int64)
        ref_id = np.empty(cap, np.int32)
        pos = np.empty(cap, np.int64)
        flag = np.empty(cap, np.uint16)
        mapq = np.empty(cap, np.uint8)
        l_seq = np.empty(cap, np.int32)
        n_cigar = np.empty(cap, np.int32)
        l_read_name = np.empty(cap, np.int32)
        ref_end_col = np.empty(cap, np.int64)
        de_col = np.empty(cap, np.float32)
        arr = np.frombuffer(self._data, dtype=np.uint8)
        ptr = lambda a, t: a.ctypes.data_as(t)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f32p = ctypes.POINTER(ctypes.c_float)
        k = nlib.scan_bam_records(
            ptr(arr, u8p), n, p, cap, ptr(rec_off, i64p), ptr(rec_end, i64p),
            ptr(ref_id, i32p), ptr(pos, i64p), ptr(flag, u16p),
            ptr(mapq, u8p), ptr(l_seq, i32p), ptr(n_cigar, i32p),
            ptr(l_read_name, i32p), ptr(ref_end_col, i64p), ptr(de_col, f32p))
        if k < 0:
            return False
        k = int(k)
        self.n_records = k
        self.rec_off = rec_off[:k].copy()
        self.rec_end = rec_end[:k].copy()
        self.ref_id = ref_id[:k].copy()
        self.pos = pos[:k].copy()
        self.flag = flag[:k].copy()
        self.mapq = mapq[:k].copy()
        self.l_seq = l_seq[:k].copy()
        self.n_cigar = n_cigar[:k].copy()
        self.l_read_name = l_read_name[:k].copy()
        self.ref_end = ref_end_col[:k].copy()
        self.de = de_col[:k].copy()
        return True

    def read(self, i: int) -> BamRead:
        return BamRead(self._buf, int(self.rec_off[i]), int(self.rec_end[i]),
                       int(self.ref_id[i]), int(self.pos[i]), int(self.flag[i]),
                       int(self.mapq[i]), int(self.l_seq[i]),
                       int(self.n_cigar[i]), int(self.l_read_name[i]))

    def qnames_at(self, idxs) -> List[str]:
        """Read names for a list of record indices, decoded straight from the
        record buffer (no per-read BamRead objects; name = NUL-terminated
        string at rec+32 of length l_read_name)."""
        buf = self._buf
        off = self.rec_off
        ln = self.l_read_name
        return [bytes(buf[o + 32:o + 32 + n - 1]).decode()
                for o, n in zip((off[idxs] if len(idxs) else []),
                                (ln[idxs] if len(idxs) else []))]

    def __len__(self) -> int:
        return self.n_records

    def __iter__(self) -> Iterator[BamRead]:
        for i in range(self.n_records):
            yield self.read(i)

    def tid(self, chrom: str) -> int:
        return self._ref_index[chrom]

    def qc_pass(self, min_mapq: int, min_read_length: int,
                divergence: float) -> np.ndarray:
        """Vectorised read-QC mask (the shared filter of every reference BAM
        pass, util.rs:652-668): mapq, length, flags, `de` tag. Cached per
        parameter triple."""
        key = (min_mapq, min_read_length, float(divergence))
        cache = getattr(self, "_qc_cache", None)
        if cache is None:
            cache = self._qc_cache = {}
        m = cache.get(key)
        if m is None:
            bad = FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_SUPPLEMENTARY
            m = ((self.mapq >= min_mapq) & (self.l_seq >= min_read_length)
                 & ((self.flag & bad) == 0)
                 & ~(np.nan_to_num(self.de, nan=-1.0) >= divergence))
            cache[key] = m
        return m

    def overlap_range(self, chrom: str, start0: int, end0: int
                      ) -> Tuple[int, int, np.ndarray]:
        """(lo, hi, mask): record range bounded by position and a mask of
        records truly overlapping [start0, end0) (0-based half-open), using
        the precomputed ref_end column — O(log n + hits)."""
        lo, hi = self.contig_record_range(chrom)
        if lo == hi:
            return lo, hi, np.zeros(0, bool)
        span = self.ref_end[lo:hi] - self.pos[lo:hi]
        max_span = int(span.max()) if span.size else 0
        lo2 = lo + int(np.searchsorted(self.pos[lo:hi], start0 - max_span,
                                       side="left"))
        hi2 = lo + int(np.searchsorted(self.pos[lo:hi], end0, side="left"))
        mask = (self.ref_end[lo2:hi2] > start0)
        return lo2, hi2, mask

    def contig_record_range(self, chrom: str) -> Tuple[int, int]:
        """[lo, hi) record index range of a contig (file is coordinate sorted)."""
        t = self._ref_index.get(chrom)
        if t is None:
            return 0, 0
        lo = int(np.searchsorted(self.ref_id, t, side="left"))
        hi = int(np.searchsorted(self.ref_id, t, side="right"))
        return lo, hi

    def fetch(self, chrom: str, start: Optional[int] = None,
              end: Optional[int] = None) -> Iterator[BamRead]:
        """Yield reads overlapping [start, end) (0-based half-open).

        Mirrors htslib fetch semantics used by the reference
        (``util.rs:637`` fetches with 1-based Region coords; callers convert).
        """
        lo, hi = self.contig_record_range(chrom)
        if lo == hi:
            return
        if end is not None:
            hi = lo + int(np.searchsorted(self.pos[lo:hi], end, side="left"))
        for i in range(lo, hi):
            r = self.read(i)
            if start is not None and r.reference_end() <= start:
                continue
            yield r


class BamWriter:
    """BGZF-backed BAM writer.

    Supports both raw record pass-through with appended aux tags (phased-BAM
    path, mirroring ``thread.rs:350-357`` push_aux of HP:i/PS:i) and
    from-scratch record synthesis (used by test fixtures / simulators).
    """

    def __init__(self, path: str, references: List[str], lengths: List[int],
                 header_text: Optional[str] = None, level: int = 6, threads: int = 4):
        self._f = open(path, "wb")
        self._w = BgzfWriter(self._f, level=level, threads=threads)
        text = header_text if header_text is not None else self._default_header(
            references, lengths)
        tb = text.encode()
        self._w.write(BAM_MAGIC + struct.pack("<i", len(tb)) + tb)
        self._w.write(struct.pack("<i", len(references)))
        for name, ln in zip(references, lengths):
            nb = name.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))

    @staticmethod
    def _default_header(references: List[str], lengths: List[int]) -> str:
        lines = ["@HD\tVN:1.6\tSO:coordinate"]
        for name, ln in zip(references, lengths):
            lines.append(f"@SQ\tSN:{name}\tLN:{ln}")
        return "\n".join(lines) + "\n"

    def write_raw(self, record: bytes, extra_tags: bytes = b"") -> None:
        self._w.write(struct.pack("<i", len(record) + len(extra_tags)))
        self._w.write(record)
        if extra_tags:
            self._w.write(extra_tags)

    def write_record(self, *, qname: str, flag: int, ref_id: int, pos: int,
                     mapq: int, cigar: np.ndarray, seq: bytes, qual: np.ndarray,
                     tags: bytes = b"", next_ref_id: int = -1, next_pos: int = -1,
                     tlen: int = 0) -> None:
        name = qname.encode() + b"\x00"
        l_seq = len(seq)
        seq_arr = np.frombuffer(seq, dtype=np.uint8)
        nib = ASCII_TO_NIBBLE[seq_arr]
        if l_seq % 2:
            nib = np.concatenate([nib, np.zeros(1, dtype=np.uint8)])
        packed = ((nib[0::2] << 4) | nib[1::2]).tobytes()
        cigar32 = np.asarray(cigar, dtype="<u4").tobytes()
        # reg2bin over the alignment span (SAM spec 5.3)
        ref_span = int(np.sum((np.asarray(cigar, dtype=np.uint64) >> 4)
                              * CONSUMES_REF[np.asarray(cigar, dtype=np.uint64) & 0xF]))
        bin_ = _reg2bin(pos, pos + max(1, ref_span))
        fixed = struct.pack("<ii2B3H4i", ref_id, pos, len(name), mapq, bin_,
                            len(cigar), flag, l_seq, next_ref_id, next_pos, tlen)
        body = fixed + name + cigar32 + packed + \
            np.asarray(qual, dtype=np.uint8).tobytes() + tags
        self._w.write(struct.pack("<i", len(body)) + body)

    def close(self) -> None:
        self._w.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _reg2bin(beg: int, end: int) -> int:
    # single transcription of the SAM 5.3 binning formula lives in bai.py
    # (a second copy here once risked BamWriter bins diverging from
    # build_bai/chunk_span bins)
    from .bai import reg2bin
    return reg2bin(beg, end)


def encode_cigar(ops_lens: List[Tuple[int, str]]) -> np.ndarray:
    """Build a cigar array from (length, op_char) pairs."""
    out = np.empty(len(ops_lens), dtype=np.uint32)
    for i, (ln, ch) in enumerate(ops_lens):
        out[i] = (ln << 4) | CIGAR_OPS.index(ch)
    return out


def tagged_record_indices(bam: "BamFile", chrom: str, start: int,
                          end: int) -> np.ndarray:
    """Record indices the phased-BAM third pass writes for one region:
    primary mapped records whose span lies inside the region under the
    replicated +1 boundary quirks (thread.rs:340-345). THE single
    definition of the write filter — run()'s serial pass, the resident
    write overlap's prepass, the streaming writer, and both multihost
    writers share it, so the overlapped paths' byte-exactness cannot
    drift from the serial oracle."""
    bad = FLAG_UNMAPPED | FLAG_SECONDARY | FLAG_SUPPLEMENTARY
    lo, hi, omask = bam.overlap_range(chrom, start, end)
    keep = (omask & ((bam.flag[lo:hi] & bad) == 0)
            # boundary-crossing reads skipped (thread.rs:340-345)
            & (bam.pos[lo:hi] + 1 >= start)
            & (bam.ref_end[lo:hi] + 1 <= end))
    return lo + np.nonzero(keep)[0]


def write_tagged_records(bam: "BamFile", ridxs, read_assignments,
                         read_phasesets, writer: "BamWriter") -> int:
    """Append records ``ridxs`` to ``writer`` with HP:i/PS:i aux tags looked
    up by read name (thread.rs:350-357): HP only when the assignment is
    nonzero, PS whenever the read has one. One native pass assembles the
    whole uncompressed stream; Python fallback writes per record. Single
    writer at a time (shares a process-global staging buffer)."""
    qnames = bam.qnames_at(ridxs)
    n = len(ridxs)
    if n == 0:
        return 0
    payload = _emit_tagged_native(bam, ridxs, qnames, read_assignments,
                                  read_phasesets, copy=False)
    if payload is None:
        payload = _emit_tagged_python(bam, ridxs, qnames, read_assignments,
                                      read_phasesets)
    writer._w.write(payload)
    return n


def collect_tagged_bytes(bam: "BamFile", ridxs, read_assignments,
                         read_phasesets) -> Tuple[bytes, int]:
    """Uncompressed tagged-record stream for ``ridxs`` as an OWNED bytes
    object (identical byte sequence to what write_tagged_records feeds the
    BGZF writer). Lets the caller hand the payload to a background writer
    thread while the source window is evicted — the streaming pipeline's
    write/compute overlap."""
    qnames = bam.qnames_at(ridxs)
    n = len(ridxs)
    if n == 0:
        return b"", 0
    payload = _emit_tagged_native(bam, ridxs, qnames, read_assignments,
                                  read_phasesets, copy=True)
    if payload is None:
        payload = _emit_tagged_python(bam, ridxs, qnames, read_assignments,
                                      read_phasesets)
    return payload, n


def _emit_tagged_python(bam: "BamFile", ridxs, qnames, read_assignments,
                        read_phasesets) -> bytes:
    """Pure-Python tagged-record assembly (the native fallback): HP only
    when the assignment is nonzero (thread.rs:351-354), PS as Aux::U32 →
    BAM type 'I' whenever the read has one (thread.rs:355). Same
    ``block_size``-prefixed framing as BamWriter.write_raw."""
    out = bytearray()
    buf = bam._buf
    for ridx, qname in zip(ridxs, qnames):
        tags = b""
        asg = read_assignments.get(qname)
        if asg is not None and asg != 0:
            tags += make_tag_bytes("HP", "i", asg)
        psv = read_phasesets.get(qname)
        if psv is not None:
            tags += make_tag_bytes("PS", "I", psv)
        rec = buf[int(bam.rec_off[ridx]):int(bam.rec_end[ridx])]
        out += struct.pack("<i", len(rec) + len(tags))
        out += rec
        out += tags
    return bytes(out)


def _emit_tagged_native(bam: "BamFile", ridxs, qnames, read_assignments,
                        read_phasesets, copy: bool):
    """Native tagged-record assembly into the shared scratch buffer.
    Returns a memoryview into the scratch (``copy=False`` — consume before
    the next call) or an owned bytes copy (``copy=True``); None when the
    native library is unavailable."""
    n = len(ridxs)
    try:
        from .. import native
        nlib = native.lib()
    except Exception:
        nlib = None
    if nlib is None or not hasattr(nlib, "bam_emit_tagged"):
        return None
    import ctypes

    from .bgzf import _scratch_buf
    hp = np.fromiter((read_assignments.get(q) or 0 for q in qnames),
                     np.int32, count=n)
    ps = np.fromiter((read_phasesets.get(q) or 0 for q in qnames),
                     np.int32, count=n)
    ps_has = np.fromiter((q in read_phasesets for q in qnames),
                         np.uint8, count=n)
    off = bam.rec_off[ridxs].astype(np.int64)
    end = bam.rec_end[ridxs].astype(np.int64)
    cap = int((end - off).sum()) + 18 * n + 64
    out = _scratch_buf("bam_emit", cap)
    data = np.frombuffer(bam._data, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ptr = lambda a, t: a.ctypes.data_as(t)
    w = nlib.bam_emit_tagged(
        ptr(data, u8p), ptr(off, i64p), ptr(end, i64p), n,
        ptr(hp, i32p), ptr(ps, i32p), ptr(ps_has, u8p),
        ptr(out, u8p), cap)
    if w < 0:
        return None
    view = memoryview(out)[:int(w)]
    return bytes(view) if copy else view


def make_tag_bytes(tag: str, typ: str, value) -> bytes:
    """Encode one aux tag (e.g. HP:i, PS:i, de:f, ts:A)."""
    head = tag.encode()
    if typ == "i":
        return head + b"i" + struct.pack("<i", int(value))
    if typ == "I":
        return head + b"I" + struct.pack("<I", int(value))
    if typ == "f":
        return head + b"f" + struct.pack("<f", float(value))
    if typ == "A":
        return head + b"A" + value.encode()
    if typ == "Z":
        return head + b"Z" + value.encode() + b"\x00"
    if typ.startswith("B"):   # e.g. "B,I": numeric array (CG long cigars)
        st = typ.split(",")[1]
        dt = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
              "i": "<i4", "I": "<u4", "f": "<f4"}[st]
        arr = np.asarray(value, dtype=dt)
        return (head + b"B" + st.encode()
                + struct.pack("<i", arr.size) + arr.tobytes())
    raise ValueError(f"unsupported tag type {typ}")


def aligned_bases_at(read: BamRead, positions: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """For sorted 0-based reference positions, return (covered_mask, bases):
    bases[j] is the read base (ASCII) aligned at positions[j] under an
    M/=/X op; uncovered (D/N/outside) positions have covered_mask False."""
    positions = np.asarray(positions, dtype=np.int64)
    n = positions.shape[0]
    covered = np.zeros(n, dtype=bool)
    bases = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return covered, bases
    seg_r: List[int] = []
    seg_q: List[int] = []
    seg_l: List[int] = []
    rpos = read.pos
    qpos = read.leading_softclips()
    for w in read.cigar:
        op = int(w) & 0xF
        ln = int(w) >> 4
        if op in (4, 5, 6):  # S,H,P
            continue
        if op in (0, 7, 8):  # M,=,X
            seg_r.append(rpos)
            seg_q.append(qpos)
            seg_l.append(ln)
            rpos += ln
            qpos += ln
        elif op == 1:        # I
            qpos += ln
        elif op in (2, 3):   # D,N
            rpos += ln
    if not seg_r:
        return covered, bases
    sr = np.asarray(seg_r)
    sl = np.asarray(seg_l)
    sq = np.asarray(seg_q)
    si = np.searchsorted(sr, positions, side="right") - 1
    sic = np.clip(si, 0, len(seg_r) - 1)
    inside = (si >= 0) & (positions < sr[sic] + sl[sic])
    if inside.any():
        hit = np.nonzero(inside)[0]
        qidx = sq[sic[hit]] + (positions[hit] - sr[sic[hit]])
        covered[hit] = True
        bases[hit] = read.seq[qidx]
    return covered, bases
