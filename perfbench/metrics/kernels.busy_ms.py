"""Device milliseconds of the program's hand-written kernels
(``phasing/cuda_kernels.py``, ``cuda_draws.py``, ``cuda_exchange.py``,
``graphs.py`` → ``csrc/*.cu``) in the profiled pass, by the profiler's
kernel names. None where the profiler saw none of them."""

# name stems of the kernels in csrc/*.cu
KERNELS = ("rows_", "cols_", "round_draws_kernel", "set_condition_kernel",
           "shard_exchange_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    secs = [s for name, s in tr["by_name"].items()
            if any(k in name for k in KERNELS)]
    return sum(secs) * 1e3 if secs else None
