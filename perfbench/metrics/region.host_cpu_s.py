"""Host seconds of the regions' pileup, fragments, read assignment and
records (``pipeline/engine.py``, ``tiles/pileup.py``,
``phasing/fragments.py``, ``phasing/assign.py``), summed over the program's
threads: the sum of its ``region_pileup``, ``region_fragments``,
``region_assign`` and ``region_records`` stage seconds, the mean over the
window's passes. CPU seconds, not wall time."""

KEYS = ("region_pileup", "region_fragments", "region_assign", "region_records")


def read(ctx):
    vals = [sum(p.stage[k] for k in KEYS) for p in ctx["passes"]
            if all(k in p.stage for k in KEYS)]
    return sum(vals) / len(vals) if vals else None
