"""Native (C++) host decoders with transparent build + graceful fallback.

``lib()`` returns the loaded ctypes library, compiling decode.cpp with g++ on
first use (cached as build/libdecode.so). If no compiler is available the
callers fall back to the pure numpy implementations.

Copied from ``longcallr_tpu/native/__init__.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
One change: the library is first written under a name that carries the
process id, so processes that build at once cannot overwrite each other's
file.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "decode.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD_DIR, "libdecode.so")
_STAMP = _SO + ".stamp"


def _fingerprint() -> str:
    """Source + compiler + host-CPU fingerprint for the -march=native build.

    mtimes are useless across git checkouts (both files get checkout time)
    and a .so built elsewhere can SIGILL under -march=native, so rebuild
    whenever any of source hash, g++ version, or the host's CPU flag set
    changes.
    """
    import hashlib

    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    try:
        out = subprocess.run(["g++", "--version"], capture_output=True,
                             timeout=30).stdout.splitlines()
        h.update(out[0] if out else b"?")
    except Exception:
        h.update(b"no-gxx")
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    h.update(line)
                    break
    except OSError:
        import platform

        h.update(platform.machine().encode())
    return h.hexdigest()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i8p = ctypes.POINTER(ctypes.c_int8)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)


def _build(fp: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    base = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
            _SRC, "-o", tmp, "-lz", "-lpthread"]
    # prefer libdeflate for the BGZF codec (htslib does the same); fall back
    # to the zlib-only build where the library/header is absent
    for cmd in (base[:-2] + ["-DUSE_LIBDEFLATE", "-ldeflate"] + base[-2:],
                base):
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=240)
            os.replace(tmp, _SO)
            with open(_STAMP, "w") as f:
                f.write(fp)
            return True
        except Exception:
            continue
    return False


def _declare(lib: ctypes.CDLL) -> None:
    lib.bgzf_inflate_many.restype = ctypes.c_int
    lib.bgzf_inflate_many.argtypes = [
        _u8p, _i64p, _i32p, _u8p, _i64p, _i32p, ctypes.c_int64, ctypes.c_int]
    try:
        lib.bgzf_deflate_many.restype = ctypes.c_int
        lib.bgzf_deflate_many.argtypes = [
            _u8p, _i64p, _i32p, _u8p, ctypes.c_int64, _i32p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.bgzf_native_backend.restype = ctypes.c_int
        lib.bgzf_native_backend.argtypes = []
    except AttributeError:  # stale .so without the deflate entry point
        pass
    lib.pileup_fill.restype = ctypes.c_int
    lib.pileup_fill.argtypes = [
        _u8p, _i64p, _i64p, ctypes.c_int64,           # data, off, end, n
        ctypes.c_int64, ctypes.c_int64, _u8p,          # start0, P, ref
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64,  # is_ont, dist, polyA
        ctypes.c_int, _f64p, _f64p,                    # min_baseq, tables
        _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,      # cnt..bwd
        _i32p, _i32p, _f64p, _f64p, _i32p]             # strands, ts, sums, bqp
    try:
        lib.pileup_fill_mt.restype = ctypes.c_int
        lib.pileup_fill_mt.argtypes = (list(lib.pileup_fill.argtypes)
                                       + [ctypes.c_int])
    except AttributeError:  # stale .so without the mt entry point
        pass
    lib.fragment_cells.restype = ctypes.c_int
    lib.fragment_cells.argtypes = [
        _u8p, _i64p, _i64p, ctypes.c_int64,
        _i64p, _u8p, _u8p, _u8p, _u8p, ctypes.c_int64,
        _i32p, _i8p, _u8p, _i64p, ctypes.c_int64]
    try:
        lib.fragment_cells_mt.restype = ctypes.c_int
        lib.fragment_cells_mt.argtypes = (list(lib.fragment_cells.argtypes)
                                          + [ctypes.c_int])
    except AttributeError:  # stale .so
        pass
    try:
        lib.bam_emit_tagged.restype = ctypes.c_int64
        lib.bam_emit_tagged.argtypes = [
            _u8p, _i64p, _i64p, ctypes.c_int64, _i32p, _i32p, _u8p,
            _u8p, ctypes.c_int64]
    except AttributeError:  # stale .so
        pass
    try:
        lib.ld_pair_counts.restype = ctypes.c_int64
        lib.ld_pair_counts.argtypes = [
            _i8p, ctypes.c_int64, ctypes.c_int64, _u8p,
            _i32p, _i32p, _i32p, ctypes.c_int64, ctypes.c_int]
    except AttributeError:  # stale .so
        pass
    try:
        lib.assign_group_hist.restype = ctypes.c_int
        lib.assign_group_hist.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _i64p, _i32p, _i8p, _u8p,
            _u8p, ctypes.c_int64, _i32p, ctypes.c_int]
        lib.assign_read_sums.restype = ctypes.c_int
        lib.assign_read_sums.argtypes = [
            ctypes.c_int64, _i64p, _i32p, _i8p, _u8p, _i8p,
            ctypes.c_int64, _f64p, _f64p, _f64p, _f64p, _i32p]
    except AttributeError:  # stale .so
        pass
    lib.scan_bam_records.restype = ctypes.c_int64
    lib.scan_bam_records.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i64p, _i64p, _i32p, _i64p,
        ctypes.POINTER(ctypes.c_uint16), _u8p, _i32p, _i32p, _i32p,
        _i64p, ctypes.POINTER(ctypes.c_float)]


def lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        fp = _fingerprint()
        stamp = None
        try:
            with open(_STAMP) as f:
                stamp = f.read().strip()
        except OSError:
            pass
        if not os.path.exists(_SO) or stamp != fp:
            if not _build(fp):
                _failed = True
                return None
        try:
            l = ctypes.CDLL(_SO)
            _declare(l)
            _lib = l
        except OSError:
            _failed = True
    return _lib


def available() -> bool:
    return lib() is not None
