"""K2/K3 launches whose blocks were wider than those of launches that fill
the card, over all K2/K3 launches in the window, in %: the program's
counters ``cos_vg.launches_wide`` over ``cos_vg.launches``
(``ops/loss_kernel.py``; a launch takes a wider block where the lanes it
prices fit the card's resident blocks at that width, which shortens one
lane's path through the kernel). A program without those counters gives
nothing."""
import sys

PROGRAM_TRACE = "option_pricing_ffn_lbfgs_tpu_torch.utils.tracing"
VG = ("loss_kernel.cos_vg_loss", "loss_kernel.cos_vg_jac",
      "loss_kernel.cos_vg_loss_f64")


def _snapshot(ctx):
    """The program's spans and counters, or None unless they are the
    window's calls: one ``entry`` span a call, as many trips of each
    engine as the calls launched K2 (search) and K3 (polish), and as many
    counted K2/K3 launches as the calls made."""
    module = sys.modules.get(PROGRAM_TRACE)
    if module is None or not ctx.calls:
        return None
    snap = module.snapshot()
    launched = lambda *keys: sum(c.launches.get(k, 0) for c in ctx.calls
                                 for k in keys)
    c = snap.counters
    if (sum(s.name == "entry" for s in snap.spans) != len(ctx.calls)
            or c.get("lbfgs.trips", 0) != launched(VG[0])
            or c.get("lm.trips", 0) != launched(VG[1])
            or c.get("cos_vg.launches", 0) != launched(*VG)):
        return None
    return snap


def read(ctx):
    snap = _snapshot(ctx)
    if snap is None:
        return None
    launches = snap.counters.get("cos_vg.launches", 0)
    wide = snap.counters.get("cos_vg.launches_wide", 0)
    return 100.0 * wide / launches if launches else None
