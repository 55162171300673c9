"""Live lanes over padded lanes, summed over every compacted wave of the
window (``calibration/calibrator.py::WAVE_LANES`` after each call), in %.
Nothing to read where no call ran a wave."""


def read(ctx):
    waves = [w for c in ctx.calls for w in c.waves]
    padded = sum(p for _, p in waves)
    if not padded:
        return None
    return 100.0 * sum(live for live, _ in waves) / padded
