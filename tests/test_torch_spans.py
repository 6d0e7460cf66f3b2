"""The port's span recorder (``longcallr_tpu_torch/utils/spans.py``) and
the spans of the batched pipeline, on the CPU; one test needs the card.

Off (the default) a span adds its wall seconds to the stage totals and
records nothing; on, each span is a record with its thread's role, its
parent on that thread, its wave and its thread CPU time. The card test
(``python -m pytest tests/test_torch_spans.py -q -m card --noconftest`` on
a machine with an NVIDIA card) holds a span against a kernel that the
profiler saw, on the profiler's clock.
"""

import json
import os
import sys
import threading
import time

import pytest
import torch

from longcallr_tpu_torch import cli
from longcallr_tpu_torch.config import preset
from longcallr_tpu_torch.phasing import optimize as TO
from longcallr_tpu_torch.pipeline.caller import run
from longcallr_tpu_torch.utils import spans
from longcallr_tpu_torch.utils.bench_workload import make_genome_workload
from longcallr_tpu_torch.utils.spans import Span, span

CPU = torch.device("cpu")

# two contigs, four loci: iterative buckets and one enumeration locus
GENOME = [("chrA", [(6000, 20, 160), (5000, 30, 200)]),
          ("chrB", [(4000, 25, 150), (5000, 20, 1300)])]

# the stage keys a batched run of GENOME reported before the stages were
# spans (the parent's run of the same input, with the same waves), and the
# count of phase problems placed in float64 on the card
STAGE_KEYS = {
    "load", "regions", "regions_pipeline", "vcf", "phased_bam",
    "phased_bam_bg", "total", "region_pileup", "region_candidates",
    "region_fragments", "region_phase", "region_assign", "region_records",
    "phase_buckets", "phase_tables", "phase_ascent1", "phase_blockflip",
    "phase_perturb", "phase_single_regions", "phase_host_placed",
    "phase_card_placed", "phase_card_f64_placed", "phase_safety_recompute"}


@pytest.fixture
def recording():
    """Recording on for the test, off and drained after it."""
    spans.enable()
    try:
        yield
    finally:
        spans.disable()
        spans.drain()


@pytest.fixture
def genome(tmp_path):
    bam, fa = str(tmp_path / "g.bam"), str(tmp_path / "g.fa")
    make_genome_workload(bam, fa, contigs=GENOME)
    return bam, fa


@pytest.fixture
def card():
    """Skips the test where this machine has no CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _run(genome, tmp_path, monkeypatch, wave_cells=1):
    # a wave a region: three waves or more, so the pipeline overlaps them
    monkeypatch.setenv("LONGCALLR_WAVE_CELLS", str(wave_cells))
    bam, fa = genome
    return run(bam, fa, str(tmp_path / "o"),
               preset("hifi-masseq").replace(threads=2), batched=True,
               device=CPU)


def _rec(id, parent, start, end, name="x", thread=1):
    return Span(id, parent, name, "main", thread, None, None, start, end, 0)


# --- the recorder ---------------------------------------------------------

def test_nesting_and_parents_across_threads(recording):
    """A span's parent is the innermost span open on its own thread; a
    thread's outermost span has none, whatever is open on another thread;
    a child takes its parent's wave; each record names its thread's role."""
    def worker(k):
        spans.set_role(f"w{k}")
        with span("t.outer", wave=k):
            with span("t.inner"):
                time.sleep(0.001)

    with span("m.outer", wave=7):
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        with span("m.inner", region=3):
            pass
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recs = spans.drain()
    by_id = {s.id: s for s in recs}
    assert len(recs) == 10 and len(by_id) == 10
    m_outer, = [s for s in recs if s.name == "m.outer"]
    m_inner, = [s for s in recs if s.name == "m.inner"]
    assert m_outer.parent is None and m_outer.role == "main"
    assert (m_inner.parent, m_inner.wave, m_inner.region) == (m_outer.id, 7, 3)
    for k in range(4):
        outer, = [s for s in recs if s.name == "t.outer" and s.wave == k]
        inner, = [s for s in recs if s.name == "t.inner" and s.wave == k]
        assert outer.parent is None
        assert inner.parent == outer.id and inner.thread == outer.thread
        assert outer.role == inner.role == f"w{k}"
        assert outer.thread != m_outer.thread
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.short == "inner"
    assert spans.drain() == []


def test_self_time_is_duration_less_child_cover(recording):
    """Made-up records: a parent of 100 ns with children covering 10-30,
    25-40 (overlapping the first) and 90-120 (past its end) keeps 100 - 40;
    recorded ones: a parent's self time is its duration less its child's."""
    recs = [_rec(1, None, 0, 100), _rec(2, 1, 10, 30), _rec(3, 1, 25, 40),
            _rec(4, 1, 90, 120), _rec(5, 2, 12, 14)]
    own = spans.self_ns(recs)
    assert own == {1: 100 - 40, 2: 18, 3: 15, 4: 30, 5: 2}
    with span("p"):
        time.sleep(0.002)
        with span("c"):
            time.sleep(0.004)
    p, c = sorted(spans.drain(), key=lambda s: s.start_ns)
    assert spans.self_ns([p, c]) == {p.id: p.ns - c.ns, c.id: c.ns}
    assert c.ns >= 4_000_000 and p.ns - c.ns >= 2_000_000
    # a sleep costs the thread next to no CPU time
    assert 0 <= c.cpu_ns < c.ns


def test_keyed_spans_add_their_seconds_on_and_off(recording):
    got = {}
    add = spans.into(got)
    with span("a.b", key="k", add=add) as sp:
        time.sleep(0.001)
    spans.disable()
    with span("a.b", key="k", add=add) as off:
        time.sleep(0.001)
    assert got["k"] == pytest.approx(sp.seconds + off.seconds)
    assert off.seconds >= 0.001
    assert [s.name for s in spans.drain()] == ["a.b"]


def test_off_spans_are_one_object_and_record_nothing():
    assert not spans.enabled()
    assert span("x") is span("y")
    with span("x", wave=1):
        with span("t", timed=True) as t:
            pass
    assert t.seconds >= 0 and spans.drain() == []


def test_many_threads_lose_no_record(recording):
    """More threads than cores, a short switch interval, a drain while they
    run: every span is drained exactly once."""
    n_threads, n_spans = 4 * (os.cpu_count() or 1) + 4, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    got = []
    try:
        def worker():
            for _ in range(n_spans):
                with span("s.outer"):
                    with span("s.inner"):
                        pass

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        got += spans.drain()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        got += spans.drain()
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 2 * n_threads * n_spans
    assert len({s.id for s in got}) == len(got)
    ids = {s.id for s in got}
    assert all(s.parent in ids for s in got if s.name == "s.inner")


def test_chrome_trace_is_on_the_unix_clock(recording, tmp_path):
    spans.set_role("main")
    before = time.time_ns()
    with span("c.x", wave=2):
        pass
    after = time.time_ns()
    recs = spans.drain()
    path = str(tmp_path / "t.json")
    spans.chrome_trace(recs, path, before)
    with open(path) as f:
        doc = json.load(f)
    assert doc["baseTimeNanoseconds"] == before
    ev, = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    meta, = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert meta["args"]["name"] == "main" and meta["tid"] == ev["tid"]
    assert ev["name"] == "c.x" and ev["args"]["wave"] == 2
    # between the Unix times read just before and just after (µs; 1 ms for
    # the reading of the clock pair)
    assert -1e3 <= ev["ts"]
    assert ev["ts"] + ev["dur"] <= (after - before) / 1e3 + 1e3


# --- the pipeline's spans -------------------------------------------------

def _known_keys():
    """Keys a run reports whatever it does: every stage the process has
    counted before (a run reports their change, 0 included)."""
    return {k if k.startswith("phase_") else f"region_{k}"
            for k in spans.STAGE_TOTALS}


def test_tracing_off_records_nothing_and_keeps_the_stage_keys(
        genome, tmp_path, monkeypatch):
    assert not spans.enabled()
    known = _known_keys()
    out = _run(genome, tmp_path, monkeypatch)
    assert spans.drain() == []
    assert set(out.stage_seconds) == STAGE_KEYS | known


def test_tracing_on_gives_each_wave_its_waits_and_finalize(
        genome, tmp_path, monkeypatch, recording):
    known = _known_keys()
    out = _run(genome, tmp_path, monkeypatch)
    recs = spans.drain()
    assert set(out.stage_seconds) == STAGE_KEYS | known
    waves = {s.wave for s in recs if s.name == "caller.prepare"}
    assert waves == set(range(len(waves))) and len(waves) >= 3
    for name in ("caller.wait_phase", "caller.finalize", "caller.prepare",
                 "caller.phase", "caller.wait_prepare"):
        mine = [s for s in recs if s.name == name]
        assert sorted(s.wave for s in mine) == sorted(waves), name
    role = {s.name: s.role for s in recs}
    assert role["caller.wait_phase"] == role["caller.finalize"] == "main"
    assert role["caller.prepare"] == "prep" and role["caller.phase"] == "phase"
    # a wave of one region runs its pileup on the prepare thread itself
    assert role["region.pileup"] == "prep" and role["bam.advance"] == "bam"
    # the phase's own spans are children of the wave's phase span
    by_id = {s.id: s for s in recs}
    for s in recs:
        if s.name.startswith("phase.") and s.role == "phase":
            top = s
            while top.parent is not None:
                top = by_id[top.parent]
            assert top.name == "caller.phase" and s.wave == top.wave
    # keyed spans add what their records say
    pile = sum(s.ns for s in recs if s.name == "region.pileup") * 1e-9
    assert out.stage_seconds["region_pileup"] == pytest.approx(pile)
    pipe, = [s for s in recs if s.name == "caller.regions_pipeline"]
    assert out.stage_seconds["regions_pipeline"] == pytest.approx(
        pipe.ns * 1e-9)


def test_f64_rerun_spans_count_the_reruns(genome, tmp_path, monkeypatch,
                                          recording):
    """Every member fails the safety net: each rerun, a bucket member's or
    a lone region's, is one ``phase.f64_rerun`` span, and both counts the
    run reports are as many."""
    monkeypatch.setattr(TO, "split_mode", lambda device: True)
    monkeypatch.setattr(TO, "F32_SAFETY_TOL", float("inf"))
    out = _run(genome, tmp_path, monkeypatch, wave_cells=32 << 20)
    recs = spans.drain()
    by_id = {s.id: s for s in recs}

    def alone(s):
        """Whether the rerun is a lone region's (the per-region path)."""
        while s.parent is not None:
            s = by_id[s.parent]
            if s.name in ("phase.single_region", "phase.host_placed"):
                return True
        return False

    reruns = [s for s in recs if s.name == "phase.f64_rerun"]
    assert out.n_f64_reruns == len(reruns) > 0
    assert out.stage_seconds["phase_safety_recompute"] == len(reruns)
    assert 0 < sum(map(alone, reruns)) < len(reruns)
    # one wave: the main thread prepares it, over the pool's threads
    assert {s.role for s in recs if s.name == "region.pileup"} == {"pool"}


def test_profile_dir_writes_the_spans_beside_the_trace(genome, tmp_path):
    bam, fa = genome
    prof = tmp_path / "prof"
    rc = cli.main(["-b", bam, "-f", fa, "-o", str(tmp_path / "c"), "-p",
                   "hifi-masseq", "--platform", "cpu", "--profile-dir",
                   str(prof)])
    assert rc == 0 and not spans.enabled()
    names = os.listdir(prof)
    trace, = [n for n in names if n.endswith(".pt.trace.json")]
    mine, = [n for n in names if n.endswith(".spans.json")]
    with open(prof / mine) as f:
        doc = json.load(f)
    with open(prof / trace) as f:
        torch_doc = json.load(f)
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {"caller.load", "caller.regions_pipeline", "caller.finalize",
            "region.pileup"} <= {e["name"] for e in events}
    # one clock: the run's torch operators (candidates and phase) lie
    # inside the region pipeline's span, some inside the candidates'
    unix = lambda d, e: d["baseTimeNanoseconds"] + e["ts"] * 1e3
    within = lambda t, e: (unix(doc, e) - 1e6 <= t
                           <= unix(doc, e) + e["dur"] * 1e3 + 1e6)
    pipe, = [e for e in events if e["name"] == "caller.regions_pipeline"]
    cands = [e for e in events if e["name"] == "caller.candidates"]
    ops = [unix(torch_doc, e) for e in torch_doc["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert ops and all(within(t, pipe) for t in ops)
    assert any(within(t, c) for t in ops for c in cands)


# --- on the card ----------------------------------------------------------

@pytest.mark.card
def test_a_kernel_lies_inside_its_span_on_the_profiler_clock(card,
                                                             recording):
    """A ``torch.cuda._sleep`` kernel launched and synced inside a span
    lies inside that span, within 1 ms, once both are on the profiler's
    clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda._sleep(1000)             # load the kernel before the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        with span("card.sleep"):
            torch.cuda._sleep(20_000_000)   # some ms at any clock rate
            torch.cuda.synchronize()
        time.sleep(0.02)
    sp, = [s for s in spans.drain() if s.name == "card.sleep"]
    start = spans.profiler_start_ns(prof)
    # at::cuda::sleep launches spin_kernel
    kernels = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
               and ("spin" in ev.name or "sleep" in ev.name)]
    assert len(kernels) == 1
    k0 = start + kernels[0].time_range.start * 1e3
    k1 = start + kernels[0].time_range.end * 1e3
    s0, s1 = spans.unix_ns(sp.start_ns), spans.unix_ns(sp.end_ns)
    assert k1 - k0 > 1e6
    assert s0 - 1e6 <= k0 and k1 <= s1 + 1e6
