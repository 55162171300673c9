"""The 95th percentile (nearest rank) over every call of the window of a
call's host-clock time, from its start until its outputs are on the
host, in ms."""
from benchmark import stats


def read(ctx):
    return 1e3 * stats.percentile([c.seconds for c in ctx.calls], 95)
