"""Search (or refine) trips a call: the program's count of float32 K2
launches (``ops/loss_kernel.py::LAUNCHES["cos_vg_loss"]``) over the
window, over the calls. Every trip of the L-BFGS is one K2."""


def read(ctx):
    if not ctx.calls:
        return None
    key = "loss_kernel.cos_vg_loss"
    return sum(c.launches.get(key, 0) for c in ctx.calls) / len(ctx.calls)
