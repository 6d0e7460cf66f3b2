"""Multi-process execution: region shards per process, gathered merge.

Port of ``longcallr_tpu/parallel/multihost.py``. The reference's
"distributed backend" is a rayon thread pool in one address space
(thread.rs:52-77). Here a pod is N processes joined by
``torch.distributed`` with the gloo backend: every process discovers the
same region list deterministically, takes its shard (size-balanced LPT),
runs the batched region pipeline against its local BAM copy on its own
device, and the per-region results — host bytes, tiny beside the compute —
are gathered to every process with ``all_gather`` on CPU tensors (the
collectives never touch the card). Process 0 retries any region a peer
failed to deliver (regions are stateless, idempotent work units) and
writes the VCF and phased BAM in contig order, as the reference's serial
writer does (thread.rs:224-361).

On one host all N processes may share one card: each runs on the device the
CLI resolves for it. With one process this degenerates to the
single-process pipeline (``pipeline/caller.run`` / ``run_streaming``).

Where gloo differs from the JAX package's collective: a peer that dies
makes gloo fail the collective at once ("Connection closed by peer")
instead of blocking in it. ``gather_results`` treats that failure as the
JAX package treats a gather that timed out (the survivor keeps its local
results and process 0 retries the dead peer's regions); any other failure
of a gather is re-raised.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CallerConfig
from ..tiles.regions import Region
from ..utils.device import resolve_device

log = logging.getLogger("longcallr_tpu_torch")

# How long process 0 waits for the pod's processes to join (the JAX
# package's jax.distributed default, 300 s).
INIT_TIMEOUT = datetime.timedelta(seconds=300)
# gloo's own bound on a collective. A week: a peer may legitimately spend
# hours on its shard while a faster process waits in the gather, and the
# gather's give-up point is LONGCALLR_GATHER_TIMEOUT (a thread join), never
# gloo's timer.
COLLECTIVE_TIMEOUT = datetime.timedelta(days=7)

# Messages of a gloo collective whose TCP connection to a peer is gone: the
# peer process died (its sockets closed) while or before this process was in
# the collective.
_PEER_LOST = ("Connection closed by peer", "Connection reset by peer",
              "Broken pipe")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join the pod: a gloo process group rendezvousing at
    ``coordinator_address`` (``host:port``, served by process 0). A no-op
    when unconfigured."""
    if coordinator_address is None and num_processes is None:
        return
    import torch.distributed as dist

    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=INIT_TIMEOUT)
    dist.init_process_group("gloo", store=store, world_size=num_processes,
                            rank=process_id, timeout=COLLECTIVE_TIMEOUT)


def shutdown_distributed() -> None:
    """Leave the pod after a run whose gather completed (a degraded
    survivor must not: see ``gather_degraded``)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _process_index() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _process_count() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_regions(regions: Sequence[Region], num_processes: int,
                  process_id: int) -> List[int]:
    """Deterministic size-balanced assignment: regions sorted by descending
    work estimate (length × max coverage), dealt to the least-loaded shard
    (LPT). Returns the indices owned by ``process_id``, in original order."""
    est = [(-(r.length * max(1, r.max_coverage or 1)), i)
           for i, r in enumerate(regions)]
    est.sort()
    loads = [0] * num_processes
    owner = [0] * len(regions)
    for negw, i in est:
        p = int(np.argmin(loads))
        owner[i] = p
        loads[p] += -negw
    return [i for i in range(len(regions)) if owner[i] == process_id]


def _encode_results(results: Dict[int, dict]) -> np.ndarray:
    raw = json.dumps(results).encode()
    return np.frombuffer(raw, dtype=np.uint8)


# set when a gather timed out or lost a peer: a timed-out gather leaves its
# thread blocked inside the collective, and after a lost peer the process
# group is broken; all later collectives in this process would desync
_gather_poisoned = False


def _gather_collective(local: Dict[int, dict]) -> Dict[int, dict]:
    """Lengths first, then the payloads padded to the global maximum, both
    as CPU tensors through ``all_gather``."""
    import torch.distributed as dist

    raw = _encode_results(local)
    n = _process_count()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(lens, torch.tensor([raw.shape[0]], dtype=torch.int64))
    lens = [int(t[0]) for t in lens]
    buf = torch.zeros(max(lens), dtype=torch.uint8)
    buf[:raw.shape[0]] = torch.from_numpy(raw.copy())
    gathered = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(gathered, buf)
    merged: Dict[int, dict] = {}
    for p in range(n):
        part = json.loads(bytes(gathered[p][:lens[p]].numpy()))
        merged.update({int(k): v for k, v in part.items()})
    return merged


def _peer_lost(exc: BaseException) -> bool:
    return isinstance(exc, RuntimeError) and any(
        m in str(exc) for m in _PEER_LOST)


def gather_results(local: Dict[int, dict],
                   timeout_s: Optional[float] = None) -> Dict[int, dict]:
    """All-gather per-region result payloads across processes.

    Payloads are JSON-serialised to uint8 and padded to the global max
    length; with one process this is the identity.

    ``timeout_s`` (or LONGCALLR_GATHER_TIMEOUT seconds, 0 = wait forever)
    bounds the collective: a peer that hangs INSIDE the all_gather would
    otherwise hang every process. On timeout, and when the collective fails
    because a peer's connection is gone (a dead peer), the local payloads
    are returned — process 0 then re-runs the missing regions serially
    (``serialize_outputs``) so the run still completes, degraded. A gather
    that fails for any other reason re-raises that failure.

    After a timeout or a lost peer this module poisons itself: the gather
    must be the last collective of the run, and later calls fail loudly
    instead of silently desyncing with the surviving peers."""
    global _gather_poisoned
    if _process_count() == 1:
        return dict(local)
    if _gather_poisoned:
        raise RuntimeError(
            "gather_results: a previous gather timed out or lost a peer; "
            "collectives in this process are unusable (restart the process "
            "to rejoin the pod)")
    if timeout_s is None:
        t = float(os.environ.get("LONGCALLR_GATHER_TIMEOUT", "0"))
        timeout_s = t if t > 0 else None
    box: dict = {}

    def run():
        try:
            box["merged"] = _gather_collective(local)
        except BaseException as e:     # noqa: BLE001 — classified below
            box["exc"] = e

    if timeout_s is None:
        run()
    else:
        th = threading.Thread(target=run, daemon=True)
        th.start()
        th.join(timeout_s)
    if "merged" in box:
        return box["merged"]
    _gather_poisoned = True
    if "exc" in box:
        if not _peer_lost(box["exc"]):
            # the gather FAILED for another reason: surface the real error
            # instead of silently re-running every peer's regions
            raise box["exc"]
        log.warning("gather_results lost a peer (%s); continuing with local "
                    "results only (missing regions will be retried on "
                    "process 0)", str(box["exc"]).splitlines()[0][:200])
        return dict(local)
    log.warning("gather_results timed out after %.0fs; continuing with local "
                "results only (missing regions will be retried on process 0)",
                timeout_s)
    return dict(local)


def gather_degraded() -> bool:
    """True when a gather timed out or lost a peer in this process. A
    degraded survivor must NOT run the normal interpreter teardown, which
    may block on the dead peer: callers that own the process exit (the CLI)
    flush their outputs and ``os._exit`` instead."""
    return _gather_poisoned


def _payload(res) -> dict:
    return dict(vcf_lines=res.vcf_lines,
                read_assignments=res.read_assignments,
                phase_sets=res.phase_sets,
                n_fragments=res.n_fragments,
                n_candidates=res.n_candidates)


_EMPTY = dict(vcf_lines=[], read_assignments={}, phase_sets={},
              n_fragments=0, n_candidates=0)


def run_local_shard(bam, fasta, regions: Sequence[Region],
                    mine: Sequence[int], cfg: CallerConfig,
                    input_candidates: Optional[dict] = None,
                    exon_regions: Optional[dict] = None,
                    ckpt=None, device: Optional[torch.device] = None
                    ) -> Tuple[Dict[int, dict], List[int]]:
    """Process this process's region shard with the batched phasing driver
    on ``device`` (``None``: the CUDA device, and it raises where there is
    none). Returns (region index → result payload, failed region indices);
    failures are isolated per region, never fatal to the shard.

    Honors the same per-region inputs as the single-process path
    (pipeline/caller.run): external -v candidates, --exon-only masks, and
    an optional RegionCheckpoint for --resume."""
    from ..phasing import batch_driver
    from ..phasing.optimize import phase_region
    from ..pipeline.caller import _exon_mask_for
    from ..pipeline.engine import RegionResult, finalize_region, prepare_region

    device = resolve_device() if device is None else torch.device(device)
    local: Dict[int, dict] = {}
    items, item_idx = [], []
    prepared = {}
    failed: List[int] = []
    for i in mine:
        reg = regions[i]
        done = ckpt.get(reg) if ckpt is not None else None
        if done is not None:
            local[i] = _payload(done)
            continue
        exon_mask = None
        if cfg.exon_only and reg.gene_id is not None:
            exon_mask = _exon_mask_for(reg, exon_regions or {})
            if exon_mask is None:
                empty = RegionResult(reg, [], {}, {}, 0, 0)
                local[i] = _payload(empty)
                if ckpt is not None:
                    ckpt.put(empty)
                continue
        try:
            ref_seq = fasta.fetch(reg.chr)
            cands, frags, apply_ds = prepare_region(
                bam, reg, ref_seq, cfg, device,
                input_candidates=input_candidates, exon_mask=exon_mask)
        except Exception:
            log.exception("region %s failed to prepare", reg)
            failed.append(i)
            continue
        prepared[i] = (cands, frags, apply_ds)
        if cands.n > 0 and frags.n_frags > 0:
            items.append((frags, cands, reg.start, apply_ds))
            item_idx.append(i)
    try:
        states = batch_driver.phase_regions_batched(items, cfg, device=device)
    except Exception:
        # one region's device-side failure must not kill the shard (the
        # per-region isolation this function promises): fall back to
        # per-region phasing; a region that still fails drops out of
        # `local` and is retried stateless on process 0
        log.exception("batched phasing of the shard failed; phasing its "
                      "regions one by one")
        states = []
        for j, (frags, cands, start, apply_ds) in enumerate(items):
            try:
                states.append(phase_region(frags, cands, cfg, seed=start,
                                           apply_downsampling=apply_ds,
                                           device=device))
            except Exception:
                log.exception("region %s failed to phase",
                              regions[item_idx[j]])
                states.append(None)
                i = item_idx[j]
                prepared.pop(i, None)
                failed.append(i)
    st_by = {item_idx[j]: states[j] for j in range(len(item_idx))}
    for i in mine:
        if i not in prepared:
            continue
        cands, frags, apply_ds = prepared[i]
        try:
            res = finalize_region(regions[i], cands, frags, st_by.get(i), cfg,
                                  apply_ds)
        except Exception:
            log.exception("region %s failed to finalize", regions[i])
            failed.append(i)
            continue
        local[i] = _payload(res)
        if ckpt is not None:
            ckpt.put(res)
    return local, failed


def _retry_region(bam, fasta, reg: Region, cfg: CallerConfig, device,
                  input_candidates, exon_regions) -> Optional[dict]:
    """Process 0's stateless re-run of a region missing from the gathered
    results under the shard pass's per-region inputs; None for a region
    that fails again (genuinely poisoned: skipped, the run goes on)."""
    from ..pipeline.caller import _exon_mask_for
    from ..pipeline.engine import process_region

    try:
        exon_mask = None
        if cfg.exon_only and reg.gene_id is not None:
            exon_mask = _exon_mask_for(reg, exon_regions or {})
            if exon_mask is None:
                return dict(_EMPTY)
        res = process_region(bam, reg, fasta.fetch(reg.chr), cfg, device,
                             input_candidates=input_candidates,
                             exon_mask=exon_mask)
        return _payload(res)
    except Exception:
        log.exception("region %s failed again on process 0; skipped", reg)
        return None


def serialize_outputs(bam, fasta, regions: Sequence[Region],
                      merged: Dict[int, dict], cfg: CallerConfig,
                      output_prefix: str,
                      input_candidates: Optional[dict] = None,
                      exon_regions: Optional[dict] = None,
                      device: Optional[torch.device] = None) -> dict:
    """Process-0 output stage: retry regions missing from the gathered
    results (peer crash / local failure — stateless re-run on ``device``)
    under the same per-region inputs as the shard pass, then write the VCF
    and phased BAM in contig order (thread.rs:224-361)."""
    from ..io.bam import BamWriter, tagged_record_indices, write_tagged_records
    from ..io.vcf import write_vcf_header

    device = resolve_device() if device is None else torch.device(device)
    missing = [i for i in range(len(regions)) if i not in merged]
    n_retried = len(missing)
    for i in missing:
        res = _retry_region(bam, fasta, regions[i], cfg, device,
                            input_candidates, exon_regions)
        if res is not None:
            merged[i] = res

    order = {c: i for i, (c, _) in enumerate(fasta.contig_lengths)}
    idx_sorted = sorted(range(len(regions)),
                        key=lambda i: (order.get(regions[i].chr, 1 << 30),
                                       regions[i].start))
    vcf_path = output_prefix + ".vcf"
    with open(vcf_path, "w") as vf:
        write_vcf_header(vf, fasta.contig_lengths)
        for i in idx_sorted:
            for line in merged.get(i, {}).get("vcf_lines", []):
                vf.write(line + "\n")

    # phased BAM (thread.rs:307-361): first-wins merges over the gathered
    # per-region assignments, raw record pass-through + appended HP/PS tags
    phased_bam_path = None
    if not cfg.no_bam_output:
        read_assignments, read_phasesets = _first_wins(merged, idx_sorted)
        phased_bam_path = output_prefix + ".phased.bam"
        with BamWriter(phased_bam_path, bam.references, bam.lengths,
                       header_text=bam.header_text,
                       level=cfg.bam_compression_level,
                       threads=max(1, cfg.threads)) as w:
            for i in idx_sorted:
                reg = regions[i]
                ridxs = tagged_record_indices(bam, reg.chr, reg.start,
                                              reg.end).tolist()
                write_tagged_records(bam, ridxs, read_assignments,
                                     read_phasesets, w)
    return {"process": 0, "vcf_path": vcf_path,
            "phased_bam_path": phased_bam_path, "n_regions": len(regions),
            "n_retried": n_retried}


def _first_wins(merged: Dict[int, dict], idxs: Sequence[int]):
    """Read → haplotype and read → phase set, the first region in ``idxs``
    that assigns a read winning (thread.rs:309-325)."""
    read_assignments: Dict[str, int] = {}
    read_phasesets: Dict[str, int] = {}
    for i in idxs:
        res = merged.get(i, {})
        for k, v in res.get("read_assignments", {}).items():
            read_assignments.setdefault(k, v)
        for k, v in res.get("phase_sets", {}).items():
            read_phasesets.setdefault(k, v)
    return read_assignments, read_phasesets


def run_multihost(bam_path: str, ref_path: str, output_prefix: str,
                  cfg: CallerConfig, stream: Optional[bool] = None,
                  device: Optional[torch.device] = None, **run_kwargs):
    """Pod caller: shard regions across processes, gather, and let process
    0 write the outputs. Returns CallerOutputs on a single process, the
    serialisation summary on process 0 of a pod, and a shard summary on
    other processes. Every device stage of this process runs on ``device``
    (``None``: the CUDA device, and it raises where there is none).

    ``stream``: per-contig BAI-windowed shard processing — each process
    keeps one contig of ITS shard resident instead of the whole BAM (the
    pod analog of --stream; outputs identical). Default AUTO: engaged for
    indexed BAMs over LONGCALLR_STREAM_AUTO_MB when no -r is given. A
    stream takes no input region, with one process as with many."""
    from ..io.bam import BamFile
    from ..io.fasta import FastaFile
    from ..pipeline.caller import build_regions, run, run_streaming
    from ..pipeline.resume import RegionCheckpoint, config_key

    device = resolve_device() if device is None else torch.device(device)
    pid = _process_index()
    n_proc = _process_count()
    if stream is None:
        auto_mb = float(os.environ.get("LONGCALLR_STREAM_AUTO_MB", "1024"))
        stream = (os.path.exists(bam_path + ".bai")
                  and os.path.getsize(bam_path) > auto_mb * 1e6
                  and not run_kwargs.get("input_region"))
    if stream and run_kwargs.get("input_region"):
        raise ValueError("streaming multihost does not take an input "
                         "region (use the resident path for -r runs)")
    if n_proc == 1:
        # degenerate 1-process pod: behave exactly like the non-pod CLI,
        # including the --stream request / AUTO above
        if stream:
            return run_streaming(
                bam_path, ref_path, output_prefix, cfg,
                contigs=run_kwargs.get("contigs"),
                input_vcf=run_kwargs.get("input_vcf"),
                anno_path=run_kwargs.get("anno_path"),
                resume=run_kwargs.get("resume", False), device=device)
        # same default as the CLI: batched AUTO (on for >1 region)
        run_kwargs.setdefault("batched", None)
        return run(bam_path, ref_path, output_prefix, cfg, device=device,
                   **run_kwargs)
    if stream:
        return _run_multihost_streaming(bam_path, ref_path, output_prefix,
                                        cfg, pid, n_proc, run_kwargs, device)

    t0 = time.monotonic()
    bam = BamFile(bam_path, threads=max(1, cfg.threads))
    fasta = FastaFile(ref_path)
    regions, exon_regions = build_regions(
        bam, fasta, cfg, run_kwargs.get("input_region"),
        run_kwargs.get("contigs"), run_kwargs.get("anno_path"))
    mine = shard_regions(regions, n_proc, pid)

    input_vcf = run_kwargs.get("input_vcf")
    input_candidates = None
    if input_vcf is not None:
        from ..io.vcf import load_input_candidates
        input_candidates = load_input_candidates(input_vcf)
    ckpt = None
    if run_kwargs.get("resume"):
        # one sidecar per process: peers must not interleave appends
        ckpt = RegionCheckpoint(
            f"{output_prefix}.regions.p{pid}.ckpt",
            key=config_key(cfg, input_vcf, run_kwargs.get("anno_path")))

    seconds = {"regions": time.monotonic() - t0}
    t0 = time.monotonic()
    local, failed = run_local_shard(bam, fasta, regions, mine, cfg,
                                    input_candidates=input_candidates,
                                    exon_regions=exon_regions, ckpt=ckpt,
                                    device=device)
    return _finish(pid, mine, failed, local, ckpt, seconds, t0,
                   lambda merged: serialize_outputs(
                       bam, fasta, regions, merged, cfg, output_prefix,
                       input_candidates=input_candidates,
                       exon_regions=exon_regions, device=device))


def _finish(pid: int, mine, failed, local, ckpt, seconds: dict, t_shard,
            write) -> dict:
    """Gather, then process 0 writes (``write(merged)``); every process
    returns its summary with the wall seconds of its stages (``regions``
    or ``discovery``, ``shard``, ``gather`` and on process 0 ``write``)."""
    t0 = time.monotonic()
    seconds["shard"] = t0 - t_shard
    merged = gather_results(local)
    if ckpt is not None:
        ckpt.close()
    seconds["gather"] = time.monotonic() - t0
    if pid != 0:
        return {"process": pid, "n_regions_local": len(mine),
                "n_failed_local": len(failed), "seconds": seconds}
    t0 = time.monotonic()
    out = write(merged)
    seconds["write"] = time.monotonic() - t0
    return {**out, "seconds": seconds}


def _run_multihost_streaming(bam_path: str, ref_path: str,
                             output_prefix: str, cfg: CallerConfig,
                             pid: int, n_proc: int, run_kwargs: dict,
                             device: torch.device):
    """Pod + whole-genome: every process discovers the SAME region list
    deterministically one contig window at a time (never holding the whole
    BAM), processes only ITS shard's contigs through BAI windows, gathers,
    and process 0 serialises per contig. Peak host memory per process is
    one contig's window (pipeline/caller.run_streaming semantics per
    shard)."""
    from ..io.bam import BamFile
    from ..io.fasta import FastaFile
    from ..pipeline.annotation import intersect_gene_regions, parse_annotation
    from ..pipeline.resume import RegionCheckpoint, config_key
    from ..tiles.regions import extract_isolated_regions_parallel

    fasta = FastaFile(ref_path)
    contigs_filter = run_kwargs.get("contigs")
    gene_regions, exon_regions = {}, {}
    anno_path = run_kwargs.get("anno_path")
    if anno_path:
        gene_regions, exon_regions = parse_annotation(anno_path)
    if cfg.exon_only and not anno_path:
        raise ValueError("exon_only is set, but annotation file is not provided")
    input_vcf = run_kwargs.get("input_vcf")
    input_candidates = None
    if input_vcf is not None:
        from ..io.vcf import load_input_candidates
        input_candidates = load_input_candidates(input_vcf)

    # pass 1: deterministic global discovery, one contig resident at a time
    t0 = time.monotonic()
    regions: List[Region] = []
    threads = max(1, cfg.threads)
    for chrom, clen in fasta.contig_lengths:
        if contigs_filter and chrom not in contigs_filter:
            continue
        win = BamFile(bam_path, threads=threads, region=(chrom, 0, clen))
        if win.n_records == 0:
            continue
        rs = extract_isolated_regions_parallel(win, [(chrom, clen)], cfg,
                                               contigs=[chrom])
        if cfg.exon_only:
            rs = intersect_gene_regions(rs, gene_regions, merge=True)
        regions.extend(rs)
        del win
        fasta.evict(chrom)

    mine = shard_regions(regions, n_proc, pid)
    ckpt = None
    if run_kwargs.get("resume"):
        ckpt = RegionCheckpoint(
            f"{output_prefix}.regions.p{pid}.ckpt",
            key=config_key(cfg, input_vcf, anno_path))
    seconds = {"discovery": time.monotonic() - t0}
    t0 = time.monotonic()

    # pass 2: my shard, contig by contig through BAI windows
    local: Dict[int, dict] = {}
    failed: List[int] = []
    by_contig: Dict[str, List[int]] = {}
    for i in mine:
        by_contig.setdefault(regions[i].chr, []).append(i)
    lens = dict(fasta.contig_lengths)
    for chrom in by_contig:
        win = BamFile(bam_path, threads=threads, region=(chrom, 0, lens[chrom]))
        loc, fl = run_local_shard(win, fasta, regions, by_contig[chrom], cfg,
                                  input_candidates=input_candidates,
                                  exon_regions=exon_regions, ckpt=ckpt,
                                  device=device)
        local.update(loc)
        failed.extend(fl)
        del win
        fasta.evict(chrom)

    return _finish(pid, mine, failed, local, ckpt, seconds, t0,
                   lambda merged: _serialize_outputs_streaming(
                       bam_path, fasta, regions, merged, cfg, output_prefix,
                       input_candidates=input_candidates,
                       exon_regions=exon_regions, device=device))


def _serialize_outputs_streaming(bam_path: str, fasta, regions, merged,
                                 cfg: CallerConfig, output_prefix: str,
                                 input_candidates=None, exon_regions=None,
                                 device: Optional[torch.device] = None):
    """Process-0 output stage of the streaming pod: retries and the phased
    BAM pass-through run against per-contig BAI windows (contig order),
    never the whole BAM."""
    from ..io.bam import (BamFile, BamWriter, tagged_record_indices,
                          write_tagged_records)
    from ..io.vcf import write_vcf_header

    device = resolve_device() if device is None else torch.device(device)
    threads = max(1, cfg.threads)
    order = {c: i for i, (c, _) in enumerate(fasta.contig_lengths)}
    lens = dict(fasta.contig_lengths)
    idx_sorted = sorted(range(len(regions)),
                        key=lambda i: (order.get(regions[i].chr, 1 << 30),
                                       regions[i].start))
    by_contig: Dict[str, List[int]] = {}
    for i in idx_sorted:
        by_contig.setdefault(regions[i].chr, []).append(i)

    n_retried = 0
    vcf_path = output_prefix + ".vcf"
    phased_bam_path = (None if cfg.no_bam_output
                       else output_prefix + ".phased.bam")
    writer = None
    try:
        with open(vcf_path, "w") as vf:
            write_vcf_header(vf, fasta.contig_lengths)
            for chrom in by_contig:
                win = BamFile(bam_path, threads=threads,
                              region=(chrom, 0, lens[chrom]))
                if writer is None and phased_bam_path:
                    writer = BamWriter(phased_bam_path, win.references,
                                       win.lengths,
                                       header_text=win.header_text,
                                       level=cfg.bam_compression_level,
                                       threads=threads)
                for i in by_contig[chrom]:
                    if i in merged:
                        continue
                    n_retried += 1
                    res = _retry_region(win, fasta, regions[i], cfg, device,
                                        input_candidates, exon_regions)
                    if res is not None:
                        merged[i] = res
                for i in by_contig[chrom]:
                    for line in merged.get(i, {}).get("vcf_lines", []):
                        vf.write(line + "\n")
                if writer is not None:
                    read_assignments, read_phasesets = _first_wins(
                        merged, by_contig[chrom])
                    for i in by_contig[chrom]:
                        reg = regions[i]
                        ridxs = tagged_record_indices(
                            win, reg.chr, reg.start, reg.end).tolist()
                        write_tagged_records(win, ridxs, read_assignments,
                                             read_phasesets, writer)
                del win
                fasta.evict(chrom)
    finally:
        if writer is not None:
            writer.close()
    if writer is None:
        # no records anywhere → no BAM was written (same contract as the
        # single-process path, caller.py): don't report a nonexistent file
        phased_bam_path = None
    return {"process": 0, "vcf_path": vcf_path,
            "phased_bam_path": phased_bam_path, "n_regions": len(regions),
            "n_retried": n_retried, "stream": True}
