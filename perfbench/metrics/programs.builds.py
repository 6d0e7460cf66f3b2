"""Device programs built in a pass (``phasing/graphs.py``): the change of
the program's ``cuda_kernels.GRAPHS["builds"]`` over a pass, the mean over
the window's passes. None where no pass built one."""


def read(ctx):
    vals = [p.graphs["builds"] for p in ctx["passes"]]
    return sum(vals) / len(vals) if vals and any(vals) else None
