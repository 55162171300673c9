"""Live lanes over launched lanes of the LM polish's trips over the
window (stage A, the waves, a winner's polish), in %: the program's
counters ``lm.lanes_live`` (each trip's real lanes live as it starts: a
wave's padding starts done, so it is never live) over
``lm.lanes_launched`` (each trip's lanes its kernels price, a wave's
padding included; ``utils/tracing.py``). The rest is work on lanes that
have finished and on padding."""
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
    launched = snap.counters.get("lm.lanes_launched", 0)
    live = snap.counters.get("lm.lanes_live", 0)
    return 100.0 * live / launched if launched else None
