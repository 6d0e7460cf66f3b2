"""Seconds a pass spends capturing and instantiating device programs
(``phasing/graphs.py``): the change of the program's
``cuda_kernels.GRAPHS`` capture and instantiate seconds over a pass, the
mean over the window's passes. None where no pass built a program."""


def read(ctx):
    vals = [p.graphs["capture_seconds"] + p.graphs["instantiate_seconds"]
            for p in ctx["passes"] if p.graphs["builds"]]
    return sum(vals) / len(vals) if vals else None
