"""Surfaces calibrated in the window (returned with a finite winner) over
the window's seconds: all the work over all the time."""
from benchmark import stats


def read(ctx):
    return stats.rate(ctx.calibrated, ctx.window_s)
