"""Seconds a pass of the resident driver (``pipeline/caller.py::run``)
waits for its phased BAM after the regions are done: the program's
``stage_seconds["phased_bam"]``, the mean over the window's passes."""


def read(ctx):
    vals = [p.stage["phased_bam"] for p in ctx["passes"] if "phased_bam" in p.stage]
    return sum(vals) / len(vals) if vals else None
