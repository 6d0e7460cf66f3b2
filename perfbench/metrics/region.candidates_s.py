"""Seconds of candidate selection (``ops/candidates.py``), summed over the
program's threads: its ``region_candidates`` stage seconds, the mean over
the window's passes."""


def read(ctx):
    vals = [p.stage["region_candidates"] for p in ctx["passes"]
            if "region_candidates" in p.stage]
    return sum(vals) / len(vals) if vals else None
