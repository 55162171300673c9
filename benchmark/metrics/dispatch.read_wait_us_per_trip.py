"""Host microseconds a trip, search and polish together, inside the
trip's one read of the live count (the host waits there for the card):
the program's counters ``lbfgs.read_ns`` + ``lm.read_ns`` over
``lbfgs.trips`` + ``lm.trips`` (``utils/tracing.py``)."""
import sys

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


def read(ctx):
    snap = _snapshot(ctx)
    if snap is None:
        return None
    c = snap.counters
    trips = c.get("lbfgs.trips", 0) + c.get("lm.trips", 0)
    spent = c.get("lbfgs.read_ns", 0) + c.get("lm.read_ns", 0)
    return spent / 1e3 / trips if trips else None
