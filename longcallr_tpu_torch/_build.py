"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a``, one ``nvcc`` per source started together, and linked into one
shared library with a plain C interface, under
``longcallr_tpu_torch/build/`` (git-ignored), and loaded with ``ctypes``.
The library's file name carries a hash of the sources and flags, so an edit
rebuilds and a stale library is never loaded. Nothing here runs at import
time: the CPU-only test suite imports every module without ``nvcc``.

``held()`` is the same library loaded so that a call keeps the interpreter
lock: for the launches of an enumeration wave's device programs
(``phasing/graphs.Launches``), which return at once and which a thread that
gave the lock up for them would wait to get back behind the other threads.
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
_held: Optional[ctypes.PyDLL] = None


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
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.split_dual_matvec_rows.restype = i
    lib.split_dual_matvec_rows.argtypes = [vp, vp, i, vp, vp, i, i, i, i, i,
                                           i, i, i, vp]
    lib.split_matvec_cols.restype = i
    lib.split_matvec_cols.argtypes = [vp, vp, i, vp, vp, vp, vp, i, i, i, i,
                                      i, i, i, vp]
    lib.split_matvec_cols_walk.restype = i
    lib.split_matvec_cols_walk.argtypes = [vp, vp, i, vp, vp, i, i, i, i, i,
                                           i, i, i, i, i, i, i, i, vp]
    lib.round_draws.restype = i
    lib.round_draws.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
    lib.sx_exchange.restype = i
    lib.sx_exchange.argtypes = [i, i, i, i, vp, vp, vp, i, vp, i, vp, vp,
                                ctypes.c_longlong, vp]
    lib.keep_best.restype = i
    lib.keep_best.argtypes = [vp, ctypes.c_longlong, vp, ctypes.c_double, vp,
                              vp, i, vp]
    lib.sx_enable_peers.restype = i
    lib.sx_enable_peers.argtypes = [i, i]
    lib.graph_kernel_nodes.restype = i
    lib.graph_kernel_nodes.argtypes = [vp, ctypes.POINTER(i)]
    pp, ull = ctypes.POINTER(vp), ctypes.c_ulonglong
    for name, args in (
            ("gp_graph_create", [i, pp]),
            ("gp_add_child", [vp, vp, vp, pp]),
            ("gp_handle_create", [vp, ctypes.POINTER(ull)]),
            ("gp_add_set", [vp, vp, ull, vp, vp, vp, pp]),
            ("gp_add_while", [vp, vp, ull, pp, pp]),
            ("gp_instantiate", [vp, i, pp]),
            ("gp_launch", [vp, i, vp]),
            ("gp_destroy", [vp, vp]),
            ("gp_stamp", [vp, vp, vp, ctypes.c_uint])):
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = args


def _check_build(cmd, returncode: int, stderr: str) -> None:
    if returncode != 0:
        raise RuntimeError("nvcc failed (exit %d):\n%s\n%s" % (
            returncode, " ".join(cmd), stderr[-4000:]))


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
            # one nvcc per source, all at once, then one link
            objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
            compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
            jobs = [[_nvcc(), *compile_flags, "-c", "-o", obj, src]
                    for src, obj in zip(srcs, objs)]
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
                     for cmd in jobs]
            try:
                for cmd, proc in zip(jobs, procs):
                    _, err = proc.communicate()
                    _check_build(cmd, proc.returncode, err)
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs]
                res = subprocess.run(cmd, capture_output=True, text=True)
                _check_build(cmd, res.returncode, res.stderr)
            finally:
                for proc in procs:
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                for obj in objs:
                    if os.path.exists(obj):
                        os.remove(obj)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        _declare(lib)
        _lib = lib
        return lib


def held() -> ctypes.PyDLL:
    """``load()``'s library, its calls made without giving up the
    interpreter lock (the package calls only ``gp_launch`` through it, from
    ``graphs.Program.enqueue``)."""
    global _held
    lib = load()
    with _lock:
        if _held is None:
            h = ctypes.PyDLL(lib._name)
            _declare(h)
            _held = h
        return _held
