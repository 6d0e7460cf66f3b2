"""BAI (BAM index) reader, writer, and region→chunk queries.

The reference opens its input through rust-htslib's ``bam::IndexedReader``
(longcallR/src/util.rs:560-613, main.rs:414-427), which requires a ``.bai``
and fetches only the BGZF blocks covering each region. This module is the
htslib-index stand-in: it parses/writes the BAI format (SAM spec §5.2 —
5-level R-tree binning, 16 kb linear index, virtual-offset chunks) and maps
a region to the compressed byte span holding its records, so whole-genome
BAMs never need to be fully resident (``BamFile(path, region=...)``).

A writer is included because this environment has no samtools/pysam: it
indexes coordinate-sorted BAMs we emit (e.g. the phased BAM) and builds
test fixtures.

Copied from ``longcallr_tpu/io/bai.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

BAI_MAGIC = b"BAI\x01"
_LINEAR_SHIFT = 14          # 16 kb linear-index windows
_BIN_LEVELS = ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681))


# BAI can only represent coordinates below 2^29 (SAM spec §5.2: 5-level
# binning; larger references need CSI, which the reference's rust-htslib
# would also need a .csi for)
_MAX_COORD = 1 << 29


def reg2bin(beg: int, end: int) -> int:
    """Smallest bin fully containing [beg, end) (SAM spec §5.3)."""
    end -= 1
    for shift, off in reversed(_BIN_LEVELS):
        if beg >> shift == end >> shift:
            return off + (beg >> shift)
    return 0


def _reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """Vectorized reg2bin over int64 arrays (identical results)."""
    e = end - 1
    out = np.zeros(beg.shape[0], np.int64)
    done = np.zeros(beg.shape[0], bool)
    for shift, off in reversed(_BIN_LEVELS):
        hit = ~done & ((beg >> shift) == (e >> shift))
        out[hit] = off + (beg[hit] >> shift)
        done |= hit
    return out


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins that may hold records overlapping [beg, end)."""
    end -= 1
    out = [0]
    for shift, off in _BIN_LEVELS:
        out.extend(range(off + (beg >> shift), off + (end >> shift) + 1))
    return out


class BaiIndex:
    """Parsed .bai: per-reference bin→chunks maps plus the linear index."""

    def __init__(self, bins: List[Dict[int, np.ndarray]],
                 intervals: List[np.ndarray]):
        self.bins = bins              # per ref: {bin: [n_chunk, 2] u64 voffs}
        self.intervals = intervals    # per ref: [n_intv] u64 ioffsets

    @classmethod
    def load(cls, path: str) -> "BaiIndex":
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != BAI_MAGIC:
            raise ValueError(f"{path}: not a BAI index")
        try:
            p = 4
            (n_ref,) = struct.unpack_from("<i", data, p)
            p += 4
            bins: List[Dict[int, np.ndarray]] = []
            intervals: List[np.ndarray] = []
            for _ in range(n_ref):
                (n_bin,) = struct.unpack_from("<i", data, p)
                p += 4
                bm: Dict[int, np.ndarray] = {}
                for _ in range(n_bin):
                    b, n_chunk = struct.unpack_from("<Ii", data, p)
                    p += 8
                    chunks = np.frombuffer(data, "<u8", n_chunk * 2, p)
                    p += 16 * n_chunk
                    bm[int(b)] = chunks.reshape(-1, 2)
                (n_intv,) = struct.unpack_from("<i", data, p)
                p += 4
                ioff = np.frombuffer(data, "<u8", n_intv, p)
                p += 8 * n_intv
                bins.append(bm)
                intervals.append(ioff)
        except (struct.error, IndexError) as e:
            # a truncated/partially-written .bai must surface as the
            # ValueError the windowed loader's fallback contract documents
            # (io/bam.py::_load_window catches ValueError → full load), not
            # as a position-dependent struct.error/IndexError
            raise ValueError(f"{path}: truncated or malformed BAI") from e
        return cls(bins, intervals)

    def chunk_span(self, ref_id: int, beg: int, end: int
                   ) -> Optional[Tuple[int, int]]:
        """Merged (voff_begin, voff_end) of all chunks that may contain
        records overlapping [beg, end) on ``ref_id``; None when no records.

        One contiguous compressed span (not a chunk list): alignment data of
        a region is nearly contiguous in a coordinate-sorted BAM, so the
        merged span reads at most a few stray blocks more while keeping the
        downstream block-decompression a single bulk operation."""
        if ref_id < 0 or ref_id >= len(self.bins):
            return None
        # BAI cannot address coordinates >= 2^29: clamp the query (htslib
        # does the same) — also keeps reg2bins inside the real bin range,
        # so an htslib-written index's metadata pseudo-bin 37450 (whose
        # "chunks" are record COUNTS, not voffs) can never enter the merge
        beg = max(0, min(beg, _MAX_COORD - 1))
        end = min(end, _MAX_COORD)
        if beg >= end:
            return None
        bm = self.bins[ref_id]
        ivs = self.intervals[ref_id]
        w = beg >> _LINEAR_SHIFT
        min_voff = int(ivs[min(w, len(ivs) - 1)]) if len(ivs) else 0
        lo, hi = None, None
        for b in reg2bins(beg, end):
            for cbeg, cend in bm.get(b, ()):
                if int(cend) <= min_voff:
                    continue
                lo = int(cbeg) if lo is None else min(lo, int(cbeg))
                hi = int(cend) if hi is None else max(hi, int(cend))
        if lo is None:
            return None
        return max(lo, min_voff), hi


def bgzf_block_table(raw: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """(coffsets, ustarts) for every BGZF block of an in-memory BAM image:
    header-only scan (BSIZE + ISIZE fields), no decompression."""
    from .bgzf import _block_size_at

    coffs: List[int] = []
    ustarts: List[int] = []
    off, total = 0, 0
    n = len(raw)
    while off < n:
        bsize = _block_size_at(raw, off)
        (isize,) = struct.unpack_from("<I", raw, off + bsize - 4)
        coffs.append(off)
        ustarts.append(total)
        total += isize
        off += bsize
    return (np.asarray(coffs, np.int64), np.asarray(ustarts, np.int64))


def build_bai(bam_path: str, out_path: Optional[str] = None) -> str:
    """Index a coordinate-sorted BAM; returns the .bai path written.

    Mirrors ``samtools index`` output minus the optional metadata pseudo-bin:
    per-bin chunks merged over file-adjacent records, linear-index windows
    backfilled with the preceding offset (SAM spec §5.2)."""
    from .bam import BamFile

    out_path = out_path or bam_path + ".bai"
    with open(bam_path, "rb") as f:
        raw = f.read()
    coffs, ustarts = bgzf_block_table(raw)
    bam = BamFile(bam_path)
    n_ref = len(bam.references)

    # placed-unmapped records (RNAME set, POS missing → pos = -1) cannot be
    # reached by a coordinate query: exclude them from the bins and the
    # linear index (a -1 pos would negative-index the linear windows;
    # htslib files such records under its metadata pseudo-bin)
    vidx = np.flatnonzero((bam.ref_id >= 0) & (bam.pos >= 0))
    rids_v = bam.ref_id[vidx]
    ordv = np.argsort(rids_v, kind="stable")       # file order within a ref
    sidx = vidx[ordv]
    bounds = np.searchsorted(rids_v[ordv], np.arange(n_ref + 1))
    for t in range(n_ref):
        sel = bam.pos[sidx[bounds[t]:bounds[t + 1]]]
        if np.any(np.diff(sel) < 0):
            raise ValueError(f"{bam_path}: not coordinate-sorted; cannot index")

    # vectorized record virtual offsets (one searchsorted pass for all
    # records instead of two scalar calls each; record start includes its
    # 4-byte block_size prefix)
    r0 = bam.rec_off[sidx].astype(np.int64) - 4
    r1 = bam.rec_end[sidx].astype(np.int64)
    j0 = np.searchsorted(ustarts, r0, side="right") - 1
    j1 = np.searchsorted(ustarts, r1, side="right") - 1
    v0_all = (coffs[j0] << 16) | (r0 - ustarts[j0])
    v1_all = (coffs[j1] << 16) | (r1 - ustarts[j1])

    buf = bytearray()
    buf += BAI_MAGIC + struct.pack("<i", n_ref)
    for t in range(n_ref):
        lo_t, hi_t = int(bounds[t]), int(bounds[t + 1])
        begs = bam.pos[sidx[lo_t:hi_t]].astype(np.int64)
        ends = np.maximum(bam.ref_end[sidx[lo_t:hi_t]].astype(np.int64),
                          begs + 1)
        bin_chunks: Dict[int, List[List[int]]] = {}
        n_intv = 0
        if begs.size:
            if int(ends.max()) > _MAX_COORD:
                # BAI cannot represent coordinates >= 2^29 (samtools
                # refuses likewise and requires CSI); writing out-of-range
                # bins would produce an index htslib misreads
                raise ValueError(
                    f"{bam_path}: reference '{bam.references[t]}' has "
                    f"alignments past the BAI 2^29 coordinate limit "
                    f"(CSI would be required; not supported)")
            n_intv = int((ends.max() - 1) >> _LINEAR_SHIFT) + 1
        ioff = np.zeros(n_intv, "<u8")             # explicit little-endian
        filled = np.zeros(n_intv, bool)
        bins_of = _reg2bin_vec(begs, ends)
        for k in range(begs.size):
            v0 = int(v0_all[lo_t + k])
            v1 = int(v1_all[lo_t + k])
            b = int(bins_of[k])
            ch = bin_chunks.setdefault(b, [])
            if ch and ch[-1][1] == v0:       # file-adjacent → merge
                ch[-1][1] = v1
            else:
                ch.append([v0, v1])
            w0 = int(begs[k]) >> _LINEAR_SHIFT
            w1 = int(ends[k] - 1) >> _LINEAR_SHIFT
            for w in range(w0, w1 + 1):
                if not filled[w] or np.uint64(v0) < ioff[w]:
                    ioff[w] = v0
                    filled[w] = True
        prev = np.uint64(0)
        for w in range(n_intv):              # backfill empty windows
            if not filled[w]:
                ioff[w] = prev
            prev = ioff[w]
        buf += struct.pack("<i", len(bin_chunks))
        for b in sorted(bin_chunks):
            ch = bin_chunks[b]
            buf += struct.pack("<Ii", b, len(ch))
            for v0, v1 in ch:
                buf += struct.pack("<QQ", v0, v1)
        buf += struct.pack("<i", n_intv)
        buf += np.ascontiguousarray(ioff).tobytes()
    with open(out_path, "wb") as f:
        f.write(bytes(buf))
    return out_path
