"""Device operations (kernels, copies, sets) the profiler recorded in
the window, over the calls: what the entry's host dispatches a call."""


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    lo, hi = ctx.trace.window
    n = sum(1 for op in ctx.trace.device if lo <= op.start <= hi)
    return n / len(ctx.calls)
