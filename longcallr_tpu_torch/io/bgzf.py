"""BGZF (blocked gzip) codec.

Stand-in for the htslib BGZF layer that the reference links through rust-htslib
(``longcallR/Cargo.toml:13``). Pure Python + zlib; block decompression is
parallelised across a thread pool (zlib releases the GIL) and is replaced by
the C++ decoder in :mod:`longcallr_tpu_torch.native` on the hot path.

Copied from ``longcallr_tpu/io/bgzf.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Iterator, List, Optional, Tuple

# gzip magic + method/flags prelude of every BGZF block
_BGZF_HEADER = b"\x1f\x8b\x08\x04"
# Standard 28-byte BGZF EOF marker block (SAM spec section 4.1.2)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

MAX_BLOCK_SIZE = 65536


class BgzfError(ValueError):
    pass


class BgzfTruncated(BgzfError):
    """The buffer ends mid-block-header: more bytes are needed, the data
    seen so far is not structurally invalid. Callers streaming a prefix
    (io/bam.py::_load_window) treat this as "incomplete tail block";
    whole-file readers surface it as the BgzfError it is."""


def _block_size_at(data: bytes, off: int) -> int:
    """Parse the BSIZE extra subfield of the BGZF block starting at ``off``.
    Raises BgzfTruncated when the buffer ends inside the header, BgzfError
    when the bytes are structurally not a BGZF block."""
    if off + 12 > len(data):
        raise BgzfTruncated(f"buffer ends inside BGZF header at offset {off}")
    if data[off:off + 4] != _BGZF_HEADER:
        raise BgzfError(f"not a BGZF block at offset {off}")
    xlen = struct.unpack_from("<H", data, off + 10)[0]
    i = off + 12
    end = i + xlen
    if end > len(data):
        raise BgzfTruncated(
            f"buffer ends inside BGZF extra field at offset {off}")
    while i + 4 <= end:
        si1, si2 = data[i], data[i + 1]
        slen = struct.unpack_from("<H", data, i + 2)[0]
        if si1 == 66 and si2 == 67:  # 'B','C'
            if i + 6 > end:
                raise BgzfError(f"BGZF block at {off}: malformed BSIZE")
            return struct.unpack_from("<H", data, i + 4)[0] + 1
        i += 4 + slen
    raise BgzfError(f"BGZF block at {off} missing BSIZE subfield")


def iter_block_spans(data: bytes) -> Iterator[Tuple[int, int]]:
    """Yield (offset, block_size) for each BGZF block in ``data``."""
    off = 0
    n = len(data)
    while off < n:
        bsize = _block_size_at(data, off)
        yield off, bsize
        off += bsize


def decompress_block(data: bytes, off: int, bsize: int, check_crc: bool = False) -> bytes:
    xlen = struct.unpack_from("<H", data, off + 10)[0]
    cstart = off + 12 + xlen
    cend = off + bsize - 8
    out = zlib.decompress(data[cstart:cend], -15)
    if check_crc:
        crc, isize = struct.unpack_from("<II", data, off + bsize - 8)
        if isize != len(out) or (zlib.crc32(out) & 0xFFFFFFFF) != crc:
            raise BgzfError(f"BGZF CRC/ISIZE mismatch in block at {off}")
    return out


def decompress_all(data: bytes, threads: int = 4, check_crc: bool = False) -> bytes:
    """Decompress a whole BGZF byte string (e.g. an entire BAM file)."""
    return decompress_blocks(data, list(iter_block_spans(data)),
                             threads=threads, check_crc=check_crc)


def decompress_blocks(data: bytes, spans: List[Tuple[int, int]],
                      threads: int = 4, check_crc: bool = False) -> bytes:
    """Decompress an explicit list of (offset, bsize) BGZF blocks of ``data``
    (the whole file, or a BAI-selected span of it).

    Uses the native multi-threaded inflater when available (zlib in C++,
    one pass, no per-block Python objects); falls back to a Python thread
    pool over blocks."""
    if not check_crc and len(spans) > 4:
        out = _decompress_all_native(data, spans, threads)
        if out is not None:
            return out
    if threads > 1 and len(spans) > 8:
        with ThreadPoolExecutor(max_workers=threads) as ex:
            parts = list(
                ex.map(lambda s: decompress_block(data, s[0], s[1], check_crc), spans)
            )
    else:
        parts = [decompress_block(data, o, b, check_crc) for o, b in spans]
    return b"".join(parts)


def _decompress_all_native(data: bytes, spans, threads: int):
    try:
        from .. import native
        nlib = native.lib()
    except Exception:
        return None
    if nlib is None:
        return None
    import ctypes

    import numpy as np

    n = len(spans)
    src_off = np.empty(n, np.int64)
    src_len = np.empty(n, np.int32)
    dst_off = np.empty(n, np.int64)
    dst_len = np.empty(n, np.int32)
    total = 0
    for j, (off, bsize) in enumerate(spans):
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        src_off[j] = off + 12 + xlen
        src_len[j] = bsize - 12 - xlen - 8
        isize = struct.unpack_from("<I", data, off + bsize - 4)[0]
        dst_off[j] = total
        dst_len[j] = isize
        total += isize
    out = np.empty(total, np.uint8)
    src = np.frombuffer(data, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ptr = lambda a, t: a.ctypes.data_as(t)
    rc = nlib.bgzf_inflate_many(
        ptr(src, u8p), ptr(src_off, i64p), ptr(src_len, i32p),
        ptr(out, u8p), ptr(dst_off, i64p), ptr(dst_len, i32p),
        n, max(1, threads))
    if rc != 0:
        return None
    return out.tobytes()


def decompress_file(path: str, threads: int = 4, check_crc: bool = False) -> bytes:
    with open(path, "rb") as f:
        return decompress_all(f.read(), threads=threads, check_crc=check_crc)


class BgzfDecompressor:
    """Random-access BGZF reader over an in-memory file image.

    Supports virtual-offset addressing (coffset << 16 | uoffset) as used by
    BAI/TBI indexes.
    """

    def __init__(self, data: bytes):
        self._data = data
        self._cache_off: int = -1
        self._cache: bytes = b""

    def block_at(self, coffset: int) -> Tuple[bytes, int]:
        """Return (uncompressed block, compressed size) at file offset."""
        if coffset == self._cache_off:
            return self._cache, self._cache_size
        bsize = _block_size_at(self._data, coffset)
        out = decompress_block(self._data, coffset, bsize)
        self._cache_off = coffset
        self._cache = out
        self._cache_size = bsize
        return out, bsize

    def read_from(self, voffset: int, nbytes: int) -> bytes:
        """Read ``nbytes`` of uncompressed data starting at a virtual offset."""
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        chunks: List[bytes] = []
        got = 0
        while got < nbytes and coffset < len(self._data):
            block, bsize = self.block_at(coffset)
            part = block[uoffset:]
            chunks.append(part)
            got += len(part)
            coffset += bsize
            uoffset = 0
        return b"".join(chunks)[:nbytes]


def compress_block(chunk: bytes, level: int = 6) -> bytes:
    """Compress ≤64KiB of data into one or more BGZF blocks.

    Incompressible payloads can deflate to >64KiB; like htslib we shrink the
    input chunk until the block fits, emitting the remainder as extra blocks.
    """
    if len(chunk) > MAX_BLOCK_SIZE:
        raise BgzfError("BGZF block payload exceeds 64KiB")
    take = len(chunk)
    while True:
        part = chunk[:take]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = co.compress(part) + co.flush()
        bsize = len(cdata) + 26  # header(12) + extra(6) + crc(4) + isize(4)
        if bsize <= MAX_BLOCK_SIZE:
            break
        take -= 1024
    header = _BGZF_HEADER + b"\x00\x00\x00\x00\x00\xff" + struct.pack(
        "<HHHH", 6, 0x4342, 2, bsize - 1
    )
    footer = struct.pack("<II", zlib.crc32(part) & 0xFFFFFFFF, len(part))
    block = header + cdata + footer
    if take < len(chunk):
        block += compress_block(chunk[take:], level)
    return block


# warm reusable scratch for the native deflater: fresh ~1MB allocations pay
# ~0.5ms/page first-touch faults on some hosts (see utils/malloc_tune.py), so
# the src/dst staging buffers are process-global and grown geometrically.
import threading as _threading

_scratch_lock = _threading.Lock()
_scratch: dict = {}


def _scratch_buf(name: str, size: int):
    import numpy as np

    buf = _scratch.get(name)
    if buf is None or buf.size < size:
        grow = 0 if buf is None else buf.size * 2
        buf = np.empty(max(size, grow, 1 << 20), np.uint8)
        _scratch[name] = buf
    return buf


def _compress_chunks_native(chunks: List[bytes], level: int,
                            threads: int) -> Optional[List[bytes]]:
    """Deflate payload chunks into BGZF blocks via the C++ multi-threaded
    deflater. Framing is identical to :func:`compress_block`; the DEFLATE
    bytes are identical only in the zlib build of decode.cpp — the
    libdeflate build (preferred when present) emits different but
    spec-valid streams, and single-chunk flushes (len<2 below) always use
    Python zlib, so a file may mix codecs across blocks. Within one
    host/build the output is deterministic (all byte-equality tests and
    the resume gate run same-build), but compressed bytes are NOT
    comparable across hosts with different native builds — compare
    decompressed records instead (io/bam.py readers do). Returns None
    when the native library is unavailable; chunks that deflate to >64KiB
    (incompressible) fall back to the Python shrink loop individually."""
    if len(chunks) < 2:
        return None
    try:
        from .. import native
        nlib = native.lib()
    except Exception:
        return None
    if nlib is None or not hasattr(nlib, "bgzf_deflate_many"):
        return None
    import ctypes

    import numpy as np

    n = len(chunks)
    cap = MAX_BLOCK_SIZE + 64
    with _scratch_lock:
        src_len = np.asarray([len(c) for c in chunks], np.int32)
        src_off = np.zeros(n, np.int64)
        np.cumsum(src_len[:-1], dtype=np.int64, out=src_off[1:])
        total = int(src_off[-1]) + int(src_len[-1])
        src = _scratch_buf("src", total)
        for j, c in enumerate(chunks):
            src[int(src_off[j]):int(src_off[j]) + len(c)] = np.frombuffer(
                c, np.uint8)
        dst = _scratch_buf("dst", n * cap)
        out_len = np.empty(n, np.int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        ptr = lambda a, t: a.ctypes.data_as(t)
        rc = nlib.bgzf_deflate_many(
            ptr(src, u8p), ptr(src_off, i64p),
            ptr(src_len, i32p), ptr(dst, u8p), cap, ptr(out_len, i32p),
            n, level, max(1, threads))
        if rc != 0:
            return None
        blocks: List[bytes] = []
        for j in range(n):
            if out_len[j] < 0:  # incompressible: python multi-block path
                blocks.append(compress_block(chunks[j], level))
            else:
                blocks.append(
                    dst[j * cap:j * cap + int(out_len[j])].tobytes())
    return blocks


class BgzfWriter:
    """Streaming BGZF writer (used by the phased-BAM emitter)."""

    def __init__(self, fileobj: BinaryIO, level: int = 6, threads: int = 4):
        self._f = fileobj
        self._level = level
        self._buf = bytearray()
        self._threads = threads
        self._pending: List[bytes] = []
        self._closed = False

    def write(self, data) -> None:
        if self._closed:
            raise BgzfError("write to a closed BgzfWriter")
        # slice fixed 64KiB chunks straight off the input (memoryview, no
        # O(n²) buffer shifting for multi-MB writes); identical chunking —
        # and therefore identical output bytes — to the simple loop form
        mv = memoryview(data)
        n = len(mv)
        pos = 0
        if self._buf:
            take = min(MAX_BLOCK_SIZE - len(self._buf), n)
            self._buf += mv[:take]
            pos = take
            if len(self._buf) >= MAX_BLOCK_SIZE:
                self._pending.append(bytes(self._buf))
                self._buf.clear()
                self._maybe_flush()
        while n - pos >= MAX_BLOCK_SIZE:
            self._pending.append(bytes(mv[pos:pos + MAX_BLOCK_SIZE]))
            pos += MAX_BLOCK_SIZE
            self._maybe_flush()
        if pos < n:
            self._buf += mv[pos:]

    def _maybe_flush(self) -> None:
        if len(self._pending) >= 64:
            self._flush_pending()

    def _flush_pending(self) -> None:
        if not self._pending:
            return
        blocks = _compress_chunks_native(self._pending, self._level,
                                         self._threads)
        if blocks is None:
            if self._threads > 1 and len(self._pending) > 2:
                with ThreadPoolExecutor(max_workers=self._threads) as ex:
                    blocks = list(
                        ex.map(lambda c: compress_block(c, self._level),
                               self._pending)
                    )
            else:
                blocks = [compress_block(c, self._level)
                          for c in self._pending]
        for b in blocks:
            self._f.write(b)
        self._pending.clear()

    def close(self) -> None:
        # idempotent: an explicit close followed by the with-block __exit__
        # must not write a second EOF block (raw fileobj) or raise on the
        # already-closed file (BamWriter closes the underlying file)
        if self._closed:
            return
        self._closed = True
        if self._buf:
            self._pending.append(bytes(self._buf))
            self._buf.clear()
        self._flush_pending()
        self._f.write(BGZF_EOF)
        self._f.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
