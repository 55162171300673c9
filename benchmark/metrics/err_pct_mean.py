"""The mean, over every surface calibrated in the window, of the
surface's mean relative repricing error against its noiseless truth (the
benchmark's float64 reference pricer), in %."""


def read(ctx):
    return float(ctx.errors.mean()) if ctx.errors.size else None
