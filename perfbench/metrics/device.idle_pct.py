"""Share of the profiled pass in which no operation ran on the device:
1 - (union of the device operations' intervals / the pass's span), both on
the profiler's own clock, as a percentage."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    idle = 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
    if not 0.0 <= idle <= 100.0:
        raise ValueError(f"an idle share of {idle} % cannot be")
    return idle
