"""FASTA / .fai reference access.

Replaces the ``bio`` crate reader used by the reference
(``longcallR/src/util.rs:214-234`` load_reference / parse_fai). Contigs are
loaded lazily through the .fai index and cached as uint8 ASCII arrays, so a
multi-host deployment replicates only the contigs its region shard touches.

Copied from ``longcallr_tpu/io/fasta.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


class FaiRecord:
    __slots__ = ("name", "length", "offset", "linebases", "linewidth")

    def __init__(self, name: str, length: int, offset: int, linebases: int, linewidth: int):
        self.name = name
        self.length = length
        self.offset = offset
        self.linebases = linebases
        self.linewidth = linewidth


def parse_fai(path: str) -> List[Tuple[str, int]]:
    """(contig, length) pairs in file order (reference util.rs:224-234)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            out.append((parts[0], int(parts[1])))
    return out


def read_fai(path: str) -> Dict[str, FaiRecord]:
    out: Dict[str, FaiRecord] = {}
    with open(path) as f:
        for line in f:
            p = line.rstrip("\n").split("\t")
            out[p[0]] = FaiRecord(p[0], int(p[1]), int(p[2]), int(p[3]), int(p[4]))
    return out


# process-global contig cache keyed by (abspath, mtime, contig): reference
# sequences are large and reused across FastaFile instances (e.g. repeated
# runs in one process); on this deployment host fresh large allocations are
# pathologically slow (see utils/malloc_tune.py)
_GLOBAL_SEQ_CACHE: Dict[Tuple[str, float, str], np.ndarray] = {}


class FastaFile:
    """Random-access FASTA with .fai index; sequences as ASCII uint8 arrays."""

    def __init__(self, path: str):
        self.path = path
        fai_path = path + ".fai"
        if not os.path.exists(fai_path):
            raise FileNotFoundError(
                f"Reference index file .fai does not exist: {fai_path}")
        self._fai = read_fai(fai_path)
        self.contig_lengths: List[Tuple[str, int]] = parse_fai(fai_path)
        self.references = [c for c, _ in self.contig_lengths]
        self._key = (os.path.abspath(path), os.path.getmtime(path))
        self._cache = _GLOBAL_SEQ_CACHE

    def __contains__(self, contig: str) -> bool:
        return contig in self._fai

    def length(self, contig: str) -> int:
        return self._fai[contig].length

    def fetch(self, contig: str) -> np.ndarray:
        """Whole-contig sequence as ASCII uint8 array.

        Case is preserved: the reference loads raw bytes (util.rs:214-222),
        and soft-masked lowercase reference bases intentionally fall through
        its candidate loop via the "unknown ref base" branch
        (candidate.rs:255-265).
        """
        ck = self._key + (contig,)
        seq = self._cache.get(ck)
        if seq is not None:
            return seq
        rec = self._fai[contig]
        nlines = (rec.length + rec.linebases - 1) // rec.linebases
        nbytes = rec.length + nlines * (rec.linewidth - rec.linebases)
        with open(self.path, "rb") as f:
            f.seek(rec.offset)
            raw = np.frombuffer(f.read(nbytes), dtype=np.uint8)
        if rec.linewidth != rec.linebases:
            # strip line terminators by reshaping full lines + tail
            term = rec.linewidth - rec.linebases
            full = (nlines - 1) * rec.linewidth
            body = raw[:full].reshape(nlines - 1, rec.linewidth)[:, :rec.linebases]
            tail = raw[full:full + (rec.length - (nlines - 1) * rec.linebases)]
            seq = np.concatenate([body.ravel(), tail])
        else:
            seq = raw[:rec.length].copy()
        self._cache[ck] = seq
        return seq

    def evict(self, contig: str) -> None:
        """Drop a contig from the process-global cache (streaming mode keeps
        at most one contig resident)."""
        self._cache.pop(self._key + (contig,), None)


def write_fasta(path: str, contigs: Dict[str, bytes], line_width: int = 60) -> None:
    """Write a FASTA plus its .fai index (test fixtures / consensus refs)."""
    fai_lines = []
    with open(path, "wb") as f:
        for name, seq in contigs.items():
            f.write(b">" + name.encode() + b"\n")
            offset = f.tell()
            for i in range(0, len(seq), line_width):
                f.write(seq[i:i + line_width] + b"\n")
            fai_lines.append(
                f"{name}\t{len(seq)}\t{offset}\t{line_width}\t{line_width + 1}")
    with open(path + ".fai", "w") as f:
        f.write("\n".join(fai_lines) + "\n")
