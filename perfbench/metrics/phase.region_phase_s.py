"""Seconds of the phase (``phasing/batch_driver.py``, ``optimize.py``,
``parallel/mesh.py``), summed over the program's threads: its
``region_phase`` stage seconds, the mean over the window's passes."""


def read(ctx):
    vals = [p.stage["region_phase"] for p in ctx["passes"]
            if "region_phase" in p.stage]
    return sum(vals) / len(vals) if vals else None
