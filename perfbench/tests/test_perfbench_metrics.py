"""The metric arithmetic on made-up inputs."""

import pytest

from harness import manifest, trace
from harness.cell import Pass, calm_passes


def _ctx(tr=None, passes=()):
    return {"passes": list(passes), "trace": tr, "workload": "x"}


def test_union_and_idle_share():
    iv = [(0.0, 1.0, "marker"), (2.0, 3.0, "rows_walk_kernel"),
          (2.5, 4.0, "cols_kernel"), (9.0, 10.0, "marker")]
    tr = trace.reduce(iv)
    assert tr["busy_s"] == pytest.approx(4.0)
    assert tr["span_s"] == pytest.approx(10.0)
    assert tr["gaps"][0][1] == pytest.approx(5.0)
    assert "after cols_kernel" in tr["gaps"][0][0]
    assert manifest.reader("device.idle_pct").read(_ctx(tr)) == pytest.approx(60.0)
    assert manifest.reader("kernels.busy_ms").read(_ctx(tr)) == pytest.approx(2500.0)


def test_an_idle_share_outside_0_to_100_raises():
    tr = {"busy_s": 2.0, "span_s": 1.0, "by_name": {}, "gaps": []}
    with pytest.raises(ValueError):
        manifest.reader("device.idle_pct").read(_ctx(tr))


def test_no_trace_no_number():
    with pytest.raises(ValueError):
        trace.reduce([])
    for name in ("device.idle_pct", "kernels.busy_ms"):
        assert manifest.reader(name).read(_ctx(None)) is None
    tr = trace.reduce([(0.0, 1.0, "marker"), (2.0, 3.0, "marker")])
    assert manifest.reader("kernels.busy_ms").read(_ctx(tr)) is None


def test_stage_readers():
    g = {"builds": 3, "capture_seconds": 0.5, "instantiate_seconds": 0.25}
    stage = {"region_pileup": 1.0, "region_fragments": 2.0, "region_assign": 3.0,
             "region_records": 4.0, "region_candidates": 5.0, "region_phase": 6.0,
             "phased_bam": 7.0}
    ps = [Pass(stage, g, 10), Pass(dict(stage, region_phase=8.0), g, 10)]
    r = lambda n: manifest.reader(n).read(_ctx(None, ps))
    assert r("region.host_cpu_s") == 10.0
    assert r("region.candidates_s") == 5.0
    assert r("phase.region_phase_s") == 7.0
    assert r("caller.phased_bam_s") == 7.0
    assert r("programs.builds") == 3
    assert r("programs.build_s") == 0.75
    none = [Pass(stage, dict(g, builds=0), 10)]
    assert manifest.reader("programs.builds").read(_ctx(None, none)) is None


def test_spans_leave_out_the_profiled_pass_and_the_next():
    g = {"builds": 1, "capture_seconds": 0.0, "instantiate_seconds": 0.0}
    ps = [Pass({"region_phase": v}, g, 10, profiled=(i == 0))
          for i, v in enumerate([9.0, 8.0, 1.0, 3.0])]
    calm = calm_passes(ps)
    assert [p.stage["region_phase"] for p in calm] == [1.0, 3.0]
    assert manifest.reader("phase.region_phase_s").read(_ctx(None, calm)) == 2.0
    assert calm_passes(ps[:2]) == []


def test_rss_peak_is_the_blocks_own():
    """The peak covers what the block touched, and a later block starts
    from its own level, not from the process's earlier peak."""
    import mmap
    import time

    from harness.rss import RssPeak

    with RssPeak() as a:
        # an anonymous mapping, which goes back to the kernel when closed
        # whatever the allocator keeps
        x = mmap.mmap(-1, 256 << 20)
        x[::4096] = b"\1" * len(x[::4096])
        time.sleep(0.2)                  # ten samples at the peak
        x.close()
    assert a.peak - a.start >= 200 << 20
    with RssPeak() as b:
        pass
    assert b.peak < a.peak - (200 << 20)
