"""The perturbation schedule as a device program (CUDA graphs) against the
same pieces launched eagerly, on one card.

    python3 experiments/torch_graphs_ab.py [out.json] [--on-only]

First each hand kernel's wrapper alone under capture (one kernel node, the
replay equal to the eager call). Then the perturbation schedule of the deep
workload's four regions (4 loci x 80 kb, 150x, 3 kb reads) as one bucket,
of its default wave of two, of one region (``optimize.perturbation_phase``)
and of the stream input's first wave (5 loci of 40 kb at 120x), each in the
order off, on, on, off (``phasing.graphs.ENABLED``): wall (host clock,
ending in a synchronise), device busy time from torch.profiler (kernel rows
only) and idle share, the idle time cut into gaps under 10 µs between two
kernels (inside a graph, or between two eager launches) and longer ones
(the host's turn: a flag read, a replay), the peak of allocated device
memory over the run above what was allocated before it, graph replays,
captures and capture seconds, launches of both kernels; results equal in
every run. With ``--on-only`` each schedule runs twice with graphs on and
never off (the A/B of two checkouts, each running this script). One JSON
line per run, then the card's name and power limit and one summary line
(also written to out.json). Compare only within one call.
Before the schedules, one chunk of 2 trips of the deep bucket's ascent
alone, eager and as a graph: time per call between CUDA events over calls
back to back beside its kernels' device time and count (``_chunk_graph``);
and each schedule three times with graphs, its host time cut into step calls,
flag reads (with the wait for the device), the round draws, the table
build and the rest (``_host_split``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

ORDER = (False, True, True, False)


def _gaps_and_peak(run, graphs_on: bool) -> dict:
    """One more call of ``run`` under torch.profiler: the idle time between
    its device kernels, in gaps under 10 µs and longer; and one call
    without it: the peak of allocated device memory above what was
    allocated before the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from longcallr_tpu_torch.phasing import graphs as G

    saved = G.ENABLED
    G.ENABLED = graphs_on
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        short = long_ = 0.0
        n_short = n_long = 0
        end = spans[0][1] if spans else 0.0
        for a, b in spans[1:]:
            gap = a - end
            if gap > 0:
                if gap < 10.0:
                    short, n_short = short + gap, n_short + 1
                else:
                    long_, n_long = long_ + gap, n_long + 1
            end = max(end, b)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
    finally:
        G.ENABLED = saved
    return {"kernels_traced": len(spans),
            "idle_in_gaps_under_10us_seconds": short / 1e6,
            "gaps_under_10us": n_short,
            "idle_in_gaps_over_10us_seconds": long_ / 1e6,
            "gaps_over_10us": n_long, "peak_device_bytes_over_held": peak}


def _chunk_graph(dev, bucket, n: int = 100) -> dict:
    """One chunk of 2 ascent trips of ``bucket`` (after a first ascent,
    split mode) as a step alone: the time per call between CUDA events over
    ``n`` calls back to back, eager and replayed, beside its kernels'
    device time and count per call from torch.profiler. Replays enqueued
    back to back leave the host out: what is left beyond the kernels' time
    is the graph's own, between its nodes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from longcallr_tpu_torch.parallel import mesh as M
    from longcallr_tpu_torch.phasing import optimize as O

    batch, states, _, _ = bucket
    on = lambda a: torch.as_tensor(a, device=dev)
    sg, dl, et, _ = M.batched_cross_optimize(batch, *map(on, states),
                                             keep_conserved=True, split=True)
    sigma_step, snp_step, _ = O._fast_steps(
        M._tables(batch, sg, True), batch.read_base, sg, batch.site_mask,
        batch.conserved, False, False, True)
    st = O.PhaseState(sg.clone(), dl.clone(), et.clone())
    active = torch.ones(sg.shape[:-1], dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)

    def chunk():
        active.fill_(True)
        count.zero_()
        O._trips(st, active, count, sigma_step, snp_step, 2)

    res = {}
    for graphs_on in (False, True):
        run = chunk
        if graphs_on:
            chunk()             # eager first: loads the kernels
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                chunk()
                graph.capture_end()
            run = graph.replay
        for _ in range(3):
            run()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(n):
            run()
        b.record()
        b.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        res["graphs_on" if graphs_on else "graphs_off"] = {
            "ms_per_call": a.elapsed_time(b) / n,
            "kernel_ms_per_call": sum(e.self_device_time_total
                                      for e in rows) / 1e3 / 20,
            "kernels_per_call": sum(e.count for e in rows) / 20}
    return res


def _host_split(run) -> dict:
    """One call of ``run`` with graphs on, no profiler, its host time cut
    by the clock: inside the runner's step calls (replays, and the first
    calls and captures) or the device program's launch (its sync
    included), inside host flag reads (the wait for the device
    included), inside the set-up's round draws (``cuda_draws.round_draws``,
    a launch on the card; in a checkout that draws on the host,
    ``rng.predraw_rounds``, the copy to the card not included), inside
    its table build (``optimize._fast_tables_for``) and the rest (the
    schedule's own Python)."""
    import importlib
    import time

    import torch

    from longcallr_tpu_torch.phasing import graphs as G
    from longcallr_tpu_torch.phasing import optimize as O

    try:
        draws = (importlib.import_module(
            "longcallr_tpu_torch.phasing.cuda_draws"), "round_draws")
    except ImportError:
        draws = (importlib.import_module("longcallr_tpu_torch.phasing.rng"),
                 "predraw_rounds")
    spent = {"steps": 0.0, "flag_reads": 0.0, "draws": 0.0, "tables": 0.0}
    # a checkout with graphs.Runner (steps replayed, flags read on the
    # host), or with graphs.Program (one launch and one sync a call)
    if hasattr(G, "Runner"):
        steps = [(G.Runner, "__call__", "steps"),
                 (G.Runner, "flag", "flag_reads")]
    else:
        steps = [(G.Program, "launch", "steps"),
                 (G, "_read_flag", "flag_reads")]
    patched = steps + [(*draws, "draws"), (O, "_fast_tables_for", "tables")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper

    for (obj, name, key), (_, _, fn) in zip(patched, saved):
        setattr(obj, name, timed(key, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    return {"wall_seconds": wall, "in_steps_seconds": spent["steps"],
            "in_flag_reads_seconds": spent["flag_reads"],
            "draws_by": f"{draws[0].__name__.rsplit('.', 1)[-1]}.{draws[1]}",
            "in_draws_seconds": spent["draws"],
            "in_table_build_seconds": spent["tables"],
            "rest_seconds": wall - sum(spent.values())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from longcallr_tpu_torch import _build
    from longcallr_tpu_torch.phasing import cuda_kernels as CK
    from longcallr_tpu_torch.phasing import optimize as O
    from longcallr_tpu_torch.utils.bench_workload import (make_deep_workload,
                                                          make_genome_workload)
    from longcallr_tpu_torch.utils.device import resolve_device

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    order = (True, True) if "--on-only" in sys.argv[1:] else ORDER
    dev = resolve_device("cuda")
    card = C._card()
    _build.load()
    rows = [{"capture": C._graph_nodes(dev)}]
    print(json.dumps(rows[0]), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        bam, fa = os.path.join(tmp, "deep.bam"), os.path.join(tmp, "deep.fa")
        make_deep_workload(bam, fa)
        sbam, sfa = os.path.join(tmp, "s.bam"), os.path.join(tmp, "s.fa")
        make_genome_workload(sbam, sfa, contigs=[
            ("chr1", [(40_000, 120, 200)] * C.STREAM_LOCI)])
        bucket = C._deep_bucket(dev, (bam, fa))
        *_, sargs = C._region_schedule(dev, (bam, fa))
        schedules = {"deep_bucket": C._bucket_schedule(dev, bucket),
                     "deep_wave": C._bucket_schedule(dev, bucket, 2),
                     "region": lambda: O.perturbation_phase(*sargs),
                     "stream_wave": C._bucket_schedule(dev, C._deep_bucket(
                         dev, (sbam, sfa), contig="chr1", n=5))}
        rows.append({"chunk_graph": _chunk_graph(dev, bucket)})
        print(json.dumps(rows[-1]), flush=True)
        rows.append({"host_split": {label: [_host_split(run)
                                            for _ in range(3)]
                                    for label, run in schedules.items()}})
        print(json.dumps(rows[-1]), flush=True)
        first = {}
        for label, run in schedules.items():
            for on in order:
                CK.reset_launches()
                out, num = C._idle_share(run, on)
                flat = C._flat(out)
                want = first.setdefault(label, flat)
                row = {"schedule": label, "graphs": on, **num,
                       **_gaps_and_peak(run, on),
                       "graph_counts": dict(CK.GRAPHS),
                       "launches": dict(CK.LAUNCHES),
                       "equal": all(torch.equal(a, b)
                                    for a, b in zip(flat, want))}
                rows.append(row)
                print(json.dumps(row), flush=True)
    ok = all(r.get("equal", True) for r in rows)
    print(card)
    summary = {"ok": ok, "card": card, "runs": rows}
    if args:
        os.makedirs(os.path.dirname(os.path.abspath(args[0])), exist_ok=True)
        with open(args[0], "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
