"""Seconds from the process's start to the first timed call: imports,
the pool and its truths, loading (or building) the kernels, the
warm-up calls."""


def read(ctx):
    return ctx.setup_s
