"""Region-granular checkpoint/resume.

The reference has no resume story (SURVEY.md §5: a crash restarts the whole
run). Here every region is an idempotent work unit, so completed region
results are appended to a JSONL sidecar; on restart, completed regions are
loaded instead of recomputed. Outputs are tiny relative to compute, so this
is nearly free.

Copied from ``longcallr_tpu/pipeline/resume.py``: the torch port
imports nothing of that package and keeps its own copy of what it needs.
The code is unchanged; ``RegionResult`` and ``Region`` are the port's
(the original reaches jax through its ``engine`` import). ``config_key``
must stay byte for byte: a checkpoint written by one package under one
configuration carries the same header key in the other.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterator, Optional, TextIO

from .engine import RegionResult
from ..tiles.regions import Region


def config_key(cfg, input_vcf: Optional[str] = None,
               anno_path: Optional[str] = None) -> str:
    """Stable digest of everything a cached region result depends on.

    Resuming under a different preset / tunable set / input VCF must not
    silently reuse results computed under the old configuration, so the
    checkpoint stores this key in a header line and discards itself on
    mismatch.
    """
    import dataclasses
    import hashlib

    parts = {"cfg": dataclasses.asdict(cfg)}
    for label, p in (("input_vcf", input_vcf), ("anno", anno_path)):
        if p is not None:
            st = os.stat(p) if os.path.exists(p) else None
            parts[label] = [os.path.abspath(p),
                            st.st_mtime if st else None,
                            st.st_size if st else None]
    blob = json.dumps(parts, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class RegionCheckpoint:
    """Append-only JSONL store of RegionResults keyed by region string.

    The first line is a ``{"__config__": <key>}`` header; an existing file
    whose header doesn't match ``key`` is discarded (stale configuration).
    """

    def __init__(self, path: Optional[str], key: Optional[str] = None):
        self.path = path
        self._done: Dict[str, RegionResult] = {}
        self._f: Optional[TextIO] = None
        self._lock = threading.Lock()
        fresh = True
        if path and os.path.exists(path):
            # a zero-parsed-line file (crash between create and header write)
            # must stay "fresh", else it would be reopened in append mode
            # with no __config__ header and every result appended in that
            # run discarded as headerless on the next resume
            first = True
            with open(path) as f:
                for line in f:
                    try:
                        d = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail write from a crash
                    fresh = False
                    if "__config__" in d:
                        first = False
                        if key is not None and d["__config__"] != key:
                            self._done.clear()
                            fresh = True
                            break
                        continue
                    if first and key is not None:
                        # headerless (pre-key) checkpoint: can't validate
                        self._done.clear()
                        fresh = True
                        break
                    first = False
                    reg = Region(chr=d["chr"], start=d["start"], end=d["end"],
                                 gene_id=d.get("gene_id"))
                    self._done[str(reg)] = RegionResult(
                        region=reg, vcf_lines=d["vcf_lines"],
                        read_assignments=d["read_assignments"],
                        phase_sets=d["phase_sets"],
                        n_fragments=d["n_fragments"],
                        n_candidates=d["n_candidates"])
        if path:
            self._f = open(path, "w" if fresh else "a")
            if fresh and key is not None:
                self._f.write(json.dumps({"__config__": key}) + "\n")
                self._f.flush()

    @property
    def n_done(self) -> int:
        return len(self._done)

    def get(self, region: Region) -> Optional[RegionResult]:
        return self._done.get(str(region))

    def put(self, res: RegionResult) -> None:
        if self._f is None:
            return
        d = dict(chr=res.region.chr, start=res.region.start,
                 end=res.region.end, gene_id=res.region.gene_id,
                 vcf_lines=res.vcf_lines,
                 read_assignments=res.read_assignments,
                 phase_sets=res.phase_sets, n_fragments=res.n_fragments,
                 n_candidates=res.n_candidates)
        line = json.dumps(d) + "\n"
        with self._lock:  # put() is called from worker threads
            self._f.write(line)
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
