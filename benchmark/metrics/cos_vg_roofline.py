"""K2/K3's share of its roofline: the least time the card could take for
the work the launches' inputs need, over the profiler's device time of
``cos_vg_kernel``, in %.

The work is ``workcount/cos_vg.py``'s frozen count for each launch, at
the COS terms of its mode (the configuration's ``KERNEL_TERMS``) and over
the lanes it launched, which the profiler does not give and are worked
out from what the harness observes. A call's first K2 launches (the
program's count of them in that call) are the search's, each over
``batch x LANES_PER_SURFACE["loss"]`` lanes; its K3 launches come in runs
of LM trips (K6, K1, K3, K7 and copies, nothing else between them): the
first run, stage A or the only polish, over ``batch x
LANES_PER_SURFACE["jac"]`` lanes, each later run over the padded lanes of
the call's next compacted wave (``WAVE_LANES``). A call whose traced
launches do not match those counts is left out, work and time alike. The
peak is ``workcount/peaks.py``'s for the card's name."""
from benchmark import trace
from benchmark.workcount import cos_vg, peaks

KERNEL = "cos_vg_kernel"
TRIP = ("lm_open_kernel", "lm_update_kernel", "cos_price_kernel", KERNEL)


def _in_trip(op) -> bool:
    return op.kind != "kernel" or op.name.startswith(TRIP)


def _launches(call, ops, batch, lanes):
    """[(lanes, mode)] of the call's cos_vg launches, or None."""
    vg = [i for i, op in enumerate(ops) if op.name.startswith(KERNEL)]
    n_loss = call.launches.get("loss_kernel.cos_vg_loss", 0)
    n_jac = call.launches.get("loss_kernel.cos_vg_jac", 0)
    if len(vg) != n_loss + n_jac:
        return None
    out = [(batch * lanes["loss"], "loss")] * n_loss
    runs, k3 = [], vg[n_loss:]
    for j, i in enumerate(k3):
        if j == 0 or not all(_in_trip(op) for op in ops[k3[j - 1] + 1:i]):
            runs.append(0)
        runs[-1] += 1
    sizes = [batch * lanes["jac"]] + [padded for _, padded in call.waves]
    if runs and len(runs) != len(sizes):
        return None
    for n, size in zip(runs, sizes):
        out += [(size, "jac")] * n
    return out


def read(ctx):
    if ctx.trace is None:
        return None
    cfg, tr = ctx.config, ctx.traffic
    n_mat = len(tr["maturities"])
    rows = n_mat * len(tr["rel_strikes"])
    calls, puts = (rows, 0) if tr["calls"] else (0, rows)
    least = spent = 0.0
    for call, ops in zip(ctx.calls, trace.per_call(ctx.trace, "")):
        launches = _launches(call, ops, tr["batch"], cfg.LANES_PER_SURFACE)
        if launches is None:
            continue
        for lanes, mode in launches:
            work = cos_vg.launch_work(lanes, cfg.KERNEL_TERMS[mode], mode,
                                      n_mat, calls, puts)
            t = peaks.least_seconds(work["ops"], work["bytes"],
                                    ctx.device["kind"])
            if t is None:
                return None
            least += t
        spent += sum(op.seconds for op in ops if op.name.startswith(KERNEL))
    return 100.0 * least / spent if spent else None
