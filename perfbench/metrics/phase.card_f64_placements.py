"""Phase problems the router placed in float64 on the card in a pass
(``utils/device.phase_placement``: a card run's enumeration regions and
buckets below ``MIN_ACCEL_PHASE_WORK``, phased member by member on the
per-region path): the program's ``phase_card_f64_placed`` stage count, the
mean over the window's passes. None where no pass reports the count (a
program without that route)."""


def read(ctx):
    vals = [p.stage["phase_card_f64_placed"] for p in ctx["passes"]
            if "phase_card_f64_placed" in p.stage]
    return sum(vals) / len(vals) if vals else None
