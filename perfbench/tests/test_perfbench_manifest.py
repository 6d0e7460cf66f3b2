"""BENCHMARK.json against the benchmark's contract, and every piece of
every cell found by its name."""

import json
import os
import re

import pytest

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"][1] == "perfbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_configs_found_by_name():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]
        for k in c["reduced"]:
            assert NAME.match(k) and k in body
        assert {"preset", "threads", "flags"} <= set(body)


def test_cells_found_by_name():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        spec = manifest.traffic(w["traffic"])
        assert hasattr(manifest.generator(spec["generator"]), "generate")
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"reads_per_s", "device_peak_mib", "host_peak_rss_mib", "setup_s"} == e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    reports = {c for c in cells
               if any(m["name"] == "reads_per_s" and c in m.get("workloads", [c])
                      for m in BENCH["end_to_end"])}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= reports
        assert callable(manifest.reader(m["name"]).read)
    for c in cells:
        assert manifest.metrics(BENCH, c, "per_layer")


@pytest.mark.parametrize("name,reads", [
    ("transcriptome", 62_028), ("genome-stream", 104_000), ("deep", 16_000),
    ("giant", 66_667)])
def test_traffic_read_counts(name, reads):
    """The read counts the cells' why lines state, from the layouts."""
    import inspect
    import math

    spec = manifest.traffic(name)
    gen = manifest.generator(spec["generator"])
    defaults = {k: v.default for k, v in inspect.signature(gen.generate).parameters.items()
                if v.default is not inspect.Parameter.empty}
    p = dict(defaults, **spec["params"])
    if spec["generator"] == "genome":
        n = sum(math.ceil(rl * cov / p["read_len"])
                for _, loci in p["contigs"] for rl, cov, _ in loci)
    elif spec["generator"] == "transcripts":
        lens, covs = p["tx_lengths"], p["coverages"]
        n = sum(math.ceil(lens[g % len(lens)] * covs[g % len(covs)] / p["read_len"])
                for g in range(p["n_contigs"] * p["loci_per_contig"]))
    else:
        n = p["n_regions"] * math.ceil(p["region_len"] * p["coverage"] / p["read_len"])
    assert n == reads
