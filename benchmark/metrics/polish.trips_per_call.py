"""LM polish trips a call: the program's count of K3 launches
(``ops/loss_kernel.py::LAUNCHES["cos_vg_jac"]``) over the window, over the
calls. Every LM trip, of stage A or of a wave, is one K3."""


def read(ctx):
    if not ctx.calls:
        return None
    key = "loss_kernel.cos_vg_jac"
    return sum(c.launches.get(key, 0) for c in ctx.calls) / len(ctx.calls)
