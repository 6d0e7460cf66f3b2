"""glibc malloc tuning for this deployment environment.

The VM pays ~0.5 ms per first-touch page fault (nested virtualisation), so
any fresh large mapping streams at only a few MB/s while warm memory runs at
GB/s. By default glibc serves big allocations via mmap and returns them on
free, so every large numpy temporary re-faults its pages. Raising
M_MMAP_THRESHOLD and disabling trim keeps those blocks on the (warm) heap.

Call ``tune()`` once at process start; it is idempotent and silently a
no-op where glibc/mallopt is unavailable.

Copied from ``longcallr_tpu/utils/malloc_tune.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged.
"""

from __future__ import annotations

import ctypes
import ctypes.util

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3

_done = False


def tune(mmap_threshold: int = 1 << 30, trim_threshold: int = 1 << 30) -> bool:
    global _done
    if _done:
        return True
    limit_blas_threads()
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        ok1 = libc.mallopt(M_MMAP_THRESHOLD, mmap_threshold)
        ok2 = libc.mallopt(M_TRIM_THRESHOLD, trim_threshold)
        _done = bool(ok1 and ok2)
    except Exception:
        _done = False
    return _done


def trim() -> bool:
    """One explicit malloc_trim(0): return freed heap blocks to the OS now.

    tune() disables automatic trimming so freed blocks stay warm; an
    explicit trim is still honored by glibc and is the honest way to reset
    the RSS floor before a memory measurement (re-faulting a trimmed
    working set runs at ~2 GB/s on this host — measured, not the ~3 MB/s
    never-touched-page pathology). Returns True if memory was released."""
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        return bool(libc.malloc_trim(0))
    except Exception:
        return False


def limit_blas_threads(n: int = 1) -> None:
    """Pin BLAS pools to one thread: the pipeline's GEMMs are small
    ([reads, 4·snps] and alike) and already run under a region thread pool,
    so OpenBLAS's own pthreads only add sync overhead and oversubscription."""
    global _blas_limiter
    try:
        import threadpoolctl
        # keep a reference: the limiter object restores original limits when
        # used as a context manager, never let it participate in one
        _blas_limiter = threadpoolctl.threadpool_limits(n, user_api="blas")
    except Exception:
        pass


_blas_limiter = None
