"""Plain BAM, BAI and FASTA files: the benchmark writes its inputs with them
and its reference reads both the inputs and the program's phased BAM.

Written from the SAM specification (sections 4 and 5) for the benchmark
alone, so that neither the inputs nor the reference's view of a file moves
when the program's own readers and writers change. Every record is kept in
one uncompressed image; a reader yields records as ``Read`` objects with the
fields the reference's transcription uses.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

BAM_MAGIC = b"BAM\x01"
BAI_MAGIC = b"BAI\x01"
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_BLOCK_DATA = 0xFF00          # uncompressed bytes a block, as htslib writes
_LINEAR_SHIFT = 14
_BIN_LEVELS = ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681))

CIGAR_OPS = "MIDNSHP=X"
_OP_S, _OP_H = 4, 5
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)
FLAG_UNMAPPED, FLAG_REVERSE = 0x4, 0x10
FLAG_SECONDARY, FLAG_SUPPLEMENTARY = 0x100, 0x800

_NIB_ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
_NIB_HI = _NIB_ASCII[np.arange(256) >> 4]
_NIB_LO = _NIB_ASCII[np.arange(256) & 0xF]
_ASCII_NIB = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    _ASCII_NIB[_c] = _i
    _ASCII_NIB[_c | 0x20] = _i
_AUX_SIZE = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4, "A": 1}
_AUX_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I",
            "f": "<f"}
_FIXED = struct.Struct("<iiBBHHHiiii")


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin that holds [beg, end) (SAM spec 5.3)."""
    end -= 1
    for shift, off in reversed(_BIN_LEVELS):
        if beg >> shift == end >> shift:
            return off + (beg >> shift)
    return 0


def _compress(chunk: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    bsize = len(cdata) + 26
    if bsize > 65536:
        raise ValueError("a BGZF block grew past 64 KiB")
    head = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff" + struct.pack(
        "<HHHH", 6, 0x4342, 2, bsize - 1)
    return head + cdata + struct.pack("<II", zlib.crc32(chunk), len(chunk))


def encode(tid: int, pos: int, qname: str, flag: int, seq: np.ndarray,
           qual: np.ndarray, tags: bytes = b"", mapq: int = 60,
           cigar: Optional[Sequence[Tuple[int, str]]] = None) -> Tuple[int, bytes]:
    """(the reference end, the record's bytes) of one alignment; ``cigar``
    is a list of (length, operation letter), ``<len>M`` where it is None."""
    n = len(seq)
    cigar = cigar or [(n, "M")]
    words = [(ln << 4) | CIGAR_OPS.index(op) for ln, op in cigar]
    end = pos + sum(ln for ln, op in cigar if op in "MDN=X")
    nib = _ASCII_NIB[np.asarray(seq, np.uint8)]
    if n % 2:
        nib = np.concatenate([nib, np.zeros(1, np.uint8)])
    name = qname.encode() + b"\0"
    body = (_FIXED.pack(tid, pos, len(name), mapq, reg2bin(pos, end),
                        len(words), flag, n, -1, -1, 0)
            + name + struct.pack(f"<{len(words)}I", *words)
            + ((nib[0::2] << 4) | nib[1::2]).tobytes()
            + np.asarray(qual, np.uint8).tobytes() + tags)
    return end, struct.pack("<i", len(body)) + body


class BamWriter:
    """Records appended in coordinate order; ``close`` compresses them in
    BGZF blocks (threads), writes the BAM and, with ``index``, its BAI."""

    def __init__(self, path: str, names: Sequence[str], lengths: Sequence[int]):
        self.path = path
        self.names, self.lengths = list(names), list(lengths)
        text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(names, lengths))
        head = bytearray(BAM_MAGIC + struct.pack("<i", len(text)) + text.encode()
                         + struct.pack("<i", len(names)))
        for n, l in zip(names, lengths):
            nb = n.encode() + b"\0"
            head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        self._parts: List[bytes] = [bytes(head)]
        self._size = len(head)
        self._spans: List[Tuple[int, int, int, int, int]] = []

    def write(self, tid: int, pos: int, qname: str, flag: int, seq: np.ndarray,
              qual: np.ndarray, tags: bytes = b"", mapq: int = 60,
              cigar: Optional[Sequence[Tuple[int, str]]] = None) -> None:
        """One record; ``cigar`` is a list of (length, operation letter),
        ``<len>M`` where it is None."""
        self.add(tid, pos, *encode(tid, pos, qname, flag, seq, qual, tags,
                                   mapq, cigar))

    def add(self, tid: int, pos: int, end: int, rec: bytes) -> None:
        """One record as ``encode`` made it."""
        self._spans.append((tid, pos, end, self._size, self._size + len(rec)))
        self._parts.append(rec)
        self._size += len(rec)

    def close(self, index: bool = False) -> None:
        data = b"".join(self._parts)
        self._parts = []
        chunks = [data[i:i + _BLOCK_DATA] for i in range(0, len(data), _BLOCK_DATA)]
        with ThreadPoolExecutor(8) as ex:
            blocks = list(ex.map(_compress, chunks))
        with open(self.path, "wb") as f:
            for b in blocks:
                f.write(b)
            f.write(BGZF_EOF)
        if index:
            # the offset of every block, and of the end-of-file block after
            # them (a record that ends the data ends at its offset 0)
            coffs = np.cumsum([0] + [len(b) for b in blocks])
            self._write_bai(self.path + ".bai", np.asarray(coffs, np.int64))

    def _write_bai(self, path: str, coffs: np.ndarray) -> None:
        n_blocks, total = len(coffs) - 1, self._size

        def voff(u: int) -> int:
            # a position where a block ends is the start of the next one
            j = n_blocks if u >= total else u // _BLOCK_DATA
            return (int(coffs[j]) << 16) | (u - j * _BLOCK_DATA if j < n_blocks else 0)

        per_ref: List[List[Tuple[int, int, int, int]]] = [[] for _ in self.names]
        for tid, beg, end, u0, u1 in self._spans:
            per_ref[tid].append((beg, end, u0, u1))
        buf = bytearray(BAI_MAGIC + struct.pack("<i", len(self.names)))
        for recs in per_ref:
            bins: Dict[int, List[List[int]]] = {}
            n_intv = ((max(e for _, e, _, _ in recs) - 1) >> _LINEAR_SHIFT) + 1 \
                if recs else 0
            lin = [None] * n_intv
            for beg, end, u0, u1 in recs:
                v0, v1 = voff(u0), voff(u1)
                ch = bins.setdefault(reg2bin(beg, end), [])
                if ch and ch[-1][1] == v0:
                    ch[-1][1] = v1
                else:
                    ch.append([v0, v1])
                for w in range(beg >> _LINEAR_SHIFT, ((end - 1) >> _LINEAR_SHIFT) + 1):
                    if lin[w] is None or v0 < lin[w]:
                        lin[w] = v0
            prev = 0
            for w in range(n_intv):
                lin[w] = prev = prev if lin[w] is None else lin[w]
            buf += struct.pack("<i", len(bins))
            for b in sorted(bins):
                buf += struct.pack("<Ii", b, len(bins[b]))
                for v0, v1 in bins[b]:
                    buf += struct.pack("<QQ", v0, v1)
            buf += struct.pack("<i", n_intv) + struct.pack(f"<{n_intv}Q", *lin)
        with open(path, "wb") as f:
            f.write(bytes(buf))


def tag_bytes(tag: str, typ: str, value) -> bytes:
    if typ == "A":
        return tag.encode() + b"A" + value.encode()
    fmt = {"i": "<i", "I": "<I", "f": "<f"}[typ]
    return tag.encode() + typ.encode() + struct.pack(fmt, value)


def write_fasta(path: str, contigs: Dict[str, bytes], width: int = 60) -> None:
    """A FASTA and its ``.fai``."""
    fai = []
    with open(path, "wb") as f:
        for name, seq in contigs.items():
            f.write(b">" + name.encode() + b"\n")
            off = f.tell()
            for i in range(0, len(seq), width):
                f.write(seq[i:i + width] + b"\n")
            fai.append(f"{name}\t{len(seq)}\t{off}\t{width}\t{width + 1}\n")
    with open(path + ".fai", "w") as f:
        f.write("".join(fai))


def read_fasta(path: str) -> Dict[str, np.ndarray]:
    """Every contig as an array of ASCII bytes."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        for chunk in f.read().split(b">")[1:]:
            head, _, body = chunk.partition(b"\n")
            out[head.split()[0].decode()] = np.frombuffer(
                body.replace(b"\n", b""), dtype=np.uint8).copy()
    return out


def _decompress(args) -> bytes:
    data, off, bsize = args
    return zlib.decompress(data[off + 18:off + bsize - 8], -15)


def _image(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    spans, off = [], 0
    while off < len(data):
        if data[off:off + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"{path}: not BGZF at byte {off}")
        bsize = struct.unpack_from("<H", data, off + 16)[0] + 1
        spans.append((data, off, bsize))
        off += bsize
    with ThreadPoolExecutor(8) as ex:
        return b"".join(ex.map(_decompress, spans))


class Read:
    """One alignment record: the fields the reference's transcription reads."""

    __slots__ = ("qname", "ref_id", "pos", "flag", "mapq", "l_seq", "cigar",
                 "_seq", "_qual", "_aux")

    def __init__(self, buf: bytes, off: int, end: int):
        (self.ref_id, self.pos, l_name, self.mapq, _, n_cigar, self.flag,
         self.l_seq, _, _, _) = _FIXED.unpack_from(buf, off)
        p = off + 32
        self.qname = buf[p:p + l_name - 1].decode()
        p += l_name
        self.cigar = np.frombuffer(buf, dtype="<u4", count=n_cigar, offset=p)
        p += 4 * n_cigar
        n_packed = (self.l_seq + 1) // 2
        self._seq = (p, n_packed)
        self._qual = p + n_packed
        self._aux = (self._qual + self.l_seq, end, buf)

    @property
    def cigar_ops(self) -> np.ndarray:
        return (self.cigar & 0xF).astype(np.uint8)

    @property
    def cigar_lens(self) -> np.ndarray:
        return (self.cigar >> 4).astype(np.int64)

    @property
    def seq(self) -> np.ndarray:
        p, n = self._seq
        raw = np.frombuffer(self._aux[2], dtype=np.uint8, count=n, offset=p)
        out = np.empty(2 * n, dtype=np.uint8)
        out[0::2] = _NIB_HI[raw]
        out[1::2] = _NIB_LO[raw]
        return out[:self.l_seq]

    @property
    def qual(self) -> np.ndarray:
        return np.frombuffer(self._aux[2], dtype=np.uint8, count=self.l_seq,
                             offset=self._qual)

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
    def strand(self) -> int:
        return 1 if self.flag & FLAG_REVERSE else 0

    def reference_end(self) -> int:
        return self.pos + int(self.cigar_lens[CONSUMES_REF[self.cigar_ops]].sum())

    def _clip(self, words) -> int:
        for w in words:
            op = int(w) & 0xF
            if op == _OP_H:
                continue
            return int(w) >> 4 if op == _OP_S else 0
        return 0

    def leading_softclips(self) -> int:
        return self._clip(self.cigar)

    def trailing_softclips(self) -> int:
        return self._clip(self.cigar[::-1])

    def get_tag(self, name: str):
        q, end, buf = self._aux
        while q + 3 <= end:
            tag, typ = buf[q:q + 2].decode(), chr(buf[q + 2])
            q += 3
            if typ in _AUX_SIZE:
                if tag == name:
                    if typ == "A":
                        return chr(buf[q])
                    return struct.unpack_from(_AUX_FMT[typ], buf, q)[0]
                q += _AUX_SIZE[typ]
            elif typ in "ZH":
                z = buf.index(b"\0", q)
                if tag == name:
                    return buf[q:z].decode()
                q = z + 1
            elif typ == "B":
                st = chr(buf[q])
                cnt = struct.unpack_from("<i", buf, q + 1)[0]
                if tag == name:
                    return np.frombuffer(buf, dtype=_AUX_FMT[st], count=cnt,
                                         offset=q + 5)
                q += 5 + cnt * _AUX_SIZE[st]
            else:
                raise ValueError(f"aux type {typ!r}")
        return None


class BamReader:
    """A whole BAM, decompressed once; ``fetch`` yields the records that
    overlap [start, end) (0-based, half-open) in file order."""

    def __init__(self, path: str = "", image: Optional[bytes] = None):
        buf = _image(path) if image is None else image
        if buf[:4] != BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack_from("<i", buf, 4)[0]
        p = 8 + l_text
        n_ref = struct.unpack_from("<i", buf, p)[0]
        p += 4
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            ln = struct.unpack_from("<i", buf, p)[0]
            self.references.append(buf[p + 4:p + 4 + ln - 1].decode())
            self.lengths.append(struct.unpack_from("<i", buf, p + 4 + ln)[0])
            p += 8 + ln
        offs, tids, poss = [], [], []
        n = len(buf)
        while p < n:
            size, tid, pos = struct.unpack_from("<iii", buf, p)
            offs.append(p + 4)
            tids.append(tid)
            poss.append(pos)
            p += 4 + size
        self.buf = buf
        self.off = np.asarray(offs + [n + 4], np.int64)
        self.ref_id = np.asarray(tids, np.int64)
        self.pos = np.asarray(poss, np.int64)

    def __len__(self) -> int:
        return len(self.pos)

    def subset(self, chrom: str, start: int, end: int) -> "BamReader":
        """A reader of the records of ``chrom`` that start before ``end``
        and end after ``start``: small enough to hand to another process."""
        t = self.references.index(chrom)
        lo = int(np.searchsorted(self.ref_id, t, side="left"))
        hi = int(np.searchsorted(self.ref_id, t, side="right"))
        hi = lo + int(np.searchsorted(self.pos[lo:hi], end, side="left"))
        head = bytearray(BAM_MAGIC + struct.pack("<ii", 0, len(self.references)))
        for n, l in zip(self.references, self.lengths):
            nb = n.encode() + b"\0"
            head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        parts = [bytes(head)]
        for i in range(lo, hi):
            if self.read(i).reference_end() > start:
                parts.append(self.buf[int(self.off[i]) - 4:int(self.off[i + 1]) - 4])
        return BamReader(image=b"".join(parts))

    def read(self, i: int) -> Read:
        return Read(self.buf, int(self.off[i]), int(self.off[i + 1]) - 4)

    def __iter__(self) -> Iterator[Read]:
        for i in range(len(self)):
            yield self.read(i)

    def fetch(self, chrom: str, start: Optional[int] = None,
              end: Optional[int] = None) -> Iterator[Read]:
        if chrom not in self.references:
            return
        t = self.references.index(chrom)
        lo = int(np.searchsorted(self.ref_id, t, side="left"))
        hi = int(np.searchsorted(self.ref_id, t, side="right"))
        if end is not None:
            hi = lo + int(np.searchsorted(self.pos[lo:hi], end, side="left"))
        for i in range(lo, hi):
            r = self.read(i)
            if start is not None and r.reference_end() <= start:
                continue
            yield r
