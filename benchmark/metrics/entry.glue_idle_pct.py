"""The device's idle time in the window that falls in the program's
glue, over the window, in %: inside an ``entry`` span of the program
(``utils/tracing.py``) but outside every ``lbfgs.loop`` and ``lm.loop``
span, where the host prepares inputs, compacts waves, runs the FFN and
reprices winners. The program's spans are on ``time.time_ns()``, which
is the profiler's clock; where an ``entry`` span does not lie inside its
call's ``bench.entry`` span to within 1 ms, the clocks disagree and the
reader gives nothing."""
import sys

from benchmark import stats

TOLERANCE_S = 1e-3
LOOPS = ("lbfgs.loop", "lm.loop")

PROGRAM_TRACE = "option_pricing_ffn_lbfgs_tpu_torch.utils.tracing"


def _snapshot(ctx):
    """The program's spans and counters, or None unless they are the
    window's calls: one ``entry`` span a call, and as many trips of each
    engine as the calls launched K2 (search) and K3 (polish)."""
    module = sys.modules.get(PROGRAM_TRACE)
    if module is None or not ctx.calls:
        return None
    snap = module.snapshot()
    launched = lambda key: sum(c.launches.get(key, 0) for c in ctx.calls)
    c = snap.counters
    if (sum(s.name == "entry" for s in snap.spans) != len(ctx.calls)
            or c.get("lbfgs.trips", 0) != launched("loss_kernel.cos_vg_loss")
            or c.get("lm.trips", 0) != launched("loss_kernel.cos_vg_jac")):
        return None
    return snap



def _overlap(xs, ys):
    """Length of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, hi - lo)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    snap = None if ctx.trace is None else _snapshot(ctx)
    if snap is None:
        return None
    seconds = lambda s: (s.start_ns * 1e-9, s.end_ns * 1e-9)
    entries = sorted(seconds(s) for s in snap.spans if s.name == "entry")
    calls = sorted((a, b) for a, b, n in ctx.trace.spans
                   if n == "bench.entry")
    if len(calls) != len(entries) or any(
            a < c - TOLERANCE_S or b > d + TOLERANCE_S
            for (a, b), (c, d) in zip(entries, calls)):
        return None
    loops = stats.merge(seconds(s) for s in snap.spans if s.name in LOOPS)
    lo, hi = ctx.trace.window
    glue = [g for a, b in stats.clip(entries, lo, hi)
            for g in stats.gaps(loops, a, b)]
    idle = stats.gaps(((op.start, op.end) for op in ctx.trace.device),
                      lo, hi)
    return 100.0 * _overlap(stats.merge(glue), idle) / ctx.trace.window_s
