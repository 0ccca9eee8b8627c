"""setup_s: process start to the first timed tick (imports, the kernels'
build or load, the tracker and its program, the pool, the lock phase and
one pass of the cell's calls).  End to end, host clock."""


def read(ctx):
    return ctx["setup_s"]
