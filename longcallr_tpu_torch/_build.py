"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``longcallr_tpu_torch/build/`` (git-ignored), and loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an edit
rebuilds and a stale library is never loaded. Nothing here runs at import
time: the CPU-only test suite imports every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))


def _fingerprint(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.split_dual_matvec_rows.restype = i
    lib.split_dual_matvec_rows.argtypes = [vp, vp, ll, vp, vp, i, i, i, i, i,
                                           vp]
    lib.split_matvec_cols.restype = i
    lib.split_matvec_cols.argtypes = [vp, vp, ll, vp, vp, vp, vp, i, i, i, i,
                                      i, i, i, vp]


def load() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` if this source hash has no
    library yet. Raises when the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        so = os.path.join(BUILD_DIR, f"libsplit_matvec_{_fingerprint(srcs)}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("nvcc failed (exit %d):\n%s\n%s" % (
                    res.returncode, " ".join(cmd), res.stderr[-4000:]))
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _declare(lib)
        _lib = lib
        return lib
