"""Host syncs of a card run's enumeration path in a pass
(``phasing/enum_wave.py``: one read a wave of enumeration regions phased as
one stream of float64 programs): the program's ``phase_enum_wave_syncs``
stage count, the mean over the window's passes. None where no pass reports
the count (a program without that path)."""


def read(ctx):
    vals = [p.stage["phase_enum_wave_syncs"] for p in ctx["passes"]
            if "phase_enum_wave_syncs" in p.stage]
    return sum(vals) / len(vals) if vals else None
