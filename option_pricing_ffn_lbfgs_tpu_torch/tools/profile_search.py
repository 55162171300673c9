"""Where the float32 search's time goes (the JAX package's
``scripts/profile_search.py``)::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.profile_search \\
        [--batches 8,64,512,2048] [--k 64] [--n-terms 64] [--out FILE] \\
        [--device cuda]

Five sections per batch size B, each over ``[B, S = 3]`` lanes of 15
options at N COS terms (the search's shapes):

  * ``scan_eval``: K chained direct calls of ``make_batch_value_and_grad``'s
    value-and-grad, each folding its gradient back into x: K2 and its
    host assembly (which the search's fused trip no longer runs), no
    optimizer bookkeeping;
  * ``scan_bookkeep``: K chained ``_two_loop_direction`` calls
    (``ops/lbfgs_batched.py``) on a full 10-pair history: the plain
    two-loop direction, no pricer;
  * ``scan_open``: K launches of K4 (``lbfgs_open``) on the same
    history with every lane opening an iteration, so each launch runs the
    two-loop on every lane (on CPU tensors, its plain version);
  * ``full_search``: ``calibrate_batch`` with ``maxeval`` capped at 160,
    reported per evaluation of the winner with the most (on the card every
    trip is fused K4, K2, fused K5 and one host read);
  * ``fused_trip``: K trips of the engine's bound fused trip
    (``ops/lbfgs_batched.py::_bind_trip``) without the read:
    ``fused_host_ms_per_trip`` is the host's time to issue one (three
    ctypes calls), ``fused_busy_ms_per_trip`` the device's time on it.

Each section's ``*_ms_per_*`` is the chained protocol's (CUDA events, the
median of 3 trials; the first call, which builds or loads the kernels,
apart). Beside it, from one more run of the section: ``*_wall_ms_per_*``,
the host's wall clock around it (after a synchronize), and
``*_busy_ms_per_*``, the device-busy time (the sum of the device-side
entries of a ``torch.profiler`` window over it; null on the CPU, where no
device is traced), and ``*_kernels_per_*``, the device entries the
window recorded (kernels and copies) over the same count. For
``full_search`` that run is capped at K evaluations, which keeps the
profiler's window to K trips. The gap between the wall and the busy time
is the time the device waits on the host. Run the tool in a process of
its own: inside a process that had run for minutes (``chip_smoke.py``
before it ran this tool in a subprocess) the profiler lost up to 20 of a
window's device records (all 17 of ``scan_open``'s), which a fresh process
keeps; the entry counts show such a loss. The ``scan_open`` and
``fused_trip`` windows, whose counts are known (K + 1 and 3 K), are taken
again when they recorded another count, up to 3 windows, and
``open_profile_windows`` / ``fused_profile_windows`` say how many were
taken (null on the CPU). ``eval_gflops`` divides K2's
operations on the starts (``ops/opcount.py``) by ``scan_eval``'s time per
trip. One JSON line per B; ``--out`` (no default) also writes them to a
file, with ``launches``, each kernel's launch count over the tool's run
(the wrappers' ``LAUNCHES``, from 0 in a fresh process).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..calibration.calibrator import calibrate_batch
from ..calibration.initial_guess import initial_guesses
from ..calibration.transforms import transform
from ..ops import cos_kernel, loss_kernel, opcount
from ..ops import lbfgs_batched as lb
from ..ops.loss_kernel import make_batch_value_and_grad
from ..utils.config import CalibrationConfig, LBFGSConfig, PricerConfig
from ..utils.timing import (device_entries, profile_complete, synchronize,
                            time_jitted)

S = 3
M_HIST = 10
RATE = 0.03


def _wall_and_busy_ms(fn, dev, expect=None):
    """(host wall ms, device-busy ms or None, device entries or None,
    profiler windows or None) of one more run of ``fn``. With ``expect``,
    the device entries a complete window holds, a window that recorded
    another count is taken again (up to 3 in all)."""
    synchronize(dev)
    t0 = time.perf_counter()
    fn()
    synchronize(dev)
    wall = (time.perf_counter() - t0) * 1e3
    if dev.type != "cuda":
        return wall, None, None, None
    prof, _, windows = profile_complete(
        fn, lambda p: expect is None or device_entries(p)[1] == expect,
        device=dev)
    busy, n = device_entries(prof)
    return wall, busy, n, windows


def profile_batch(b: int, k: int, n_terms: int, device) -> dict:
    """The three sections at batch ``b``: one JSON row."""
    dev = torch.device(device)
    f32 = torch.float32
    cfg = CalibrationConfig(pricer=PricerConfig(n_terms=n_terms),
                            lbfgs=LBFGSConfig(maxeval=160))
    grid = lambda a: torch.tensor(np.asarray(a), dtype=f32,
                                  device=dev).expand(b, 15).contiguous()
    bs = grid(np.tile([90.0, 95.0, 100.0, 105.0, 110.0], 3))
    bm = grid(np.repeat([0.25, 0.5, 1.0], 5))
    bc = torch.ones((b, 15), dtype=torch.bool, device=dev)
    bp = grid(np.linspace(2.0, 14.0, 15))   # plausible positive prices
    spots = torch.full((b,), 100.0, dtype=f32, device=dev)
    x0 = initial_guesses(S, torch.Generator().manual_seed(b), spots, bs, bm,
                         bp)

    # 1. chained value-and-grad over the B * S lanes
    rep = lambda a: torch.repeat_interleave(a, S, dim=0)
    vg = make_batch_value_and_grad(rep(spots), rep(bs), rep(bm), rep(bc),
                                   rep(bp), RATE, cfg)
    x_flat = x0.reshape(b * S, 13)

    def scan_eval():
        x = x_flat
        for _ in range(k):
            f, g = vg(x)
            x = x - 1e-6 * g
        return f.sum() + x.sum()

    # 2. chained two-loop directions over the B * S lanes
    gen = torch.Generator().manual_seed(1)
    rnd = lambda *shape: torch.randn(shape, generator=gen, dtype=f32).to(dev)
    g0 = rnd(b * S, 13)
    s_h, y_h = rnd(b * S, M_HIST, 13), rnd(b * S, M_HIST, 13)
    rho = rnd(b * S, M_HIST).abs()
    hist_len = torch.full((b * S,), M_HIST, dtype=torch.int32, device=dev)
    head = torch.zeros((b * S,), dtype=torch.int32, device=dev)
    gamma = torch.ones((b * S,), dtype=f32, device=dev)

    def scan_bookkeep():
        g = g0
        for _ in range(k):
            d = lb._two_loop_direction(g, s_h, y_h, rho, hist_len, head,
                                       gamma)
            g = d * 0.999 + g * 1e-3
        return g.sum()

    # 3. K4 on the same history, every lane opening: the live fields are
    # set once and K4 rewrites the same opening fields on every launch
    st = lb.init_state(torch.zeros_like(g0), M_HIST)._replace(
        g=g0, s_hist=s_h.contiguous(), y_hist=y_h.contiguous(),
        rho_hist=rho.contiguous(), hist_len=hist_len.clone(),
        head=head.clone(), gamma=gamma.clone())
    st.bootstrap.zero_()
    st.starting.fill_(True)
    open_cfg = LBFGSConfig(history=M_HIST)
    status = torch.zeros(2, dtype=torch.int32, device=dev)

    def scan_open():
        for _ in range(k):
            x_try = lb.lbfgs_open(st, open_cfg, status)
        return x_try.sum()

    # 4. the real search; its wall and busy time come from a run capped at
    # K evaluations (a trip costs the same early and late, and a profiler
    # window over all 160 trips holds ~100,000 device launches)
    search = lambda c: (lambda: calibrate_batch(
        spots, RATE, bs, bm, bc, bp, config=c, n_starts=S, x0=x0,
        device=dev))
    full = search(cfg)
    full_k = search(CalibrationConfig(pricer=cfg.pricer,
                                      lbfgs=LBFGSConfig(maxeval=k)))

    # 5. the bound fused trip, K times from the bootstrapped state, without
    # the read (done lanes hold, so later trips cost what the first did)
    st5 = lb.init_state(x_flat, cfg.lbfgs.history)
    status5 = torch.zeros(2, dtype=torch.int32, device=dev)
    trip = lb._bind_trip(vg, st5, cfg.lbfgs, status5, plain=False)
    trip()
    lb.read_live(status5)

    def fused_trips():
        for _ in range(k):
            trip()

    synchronize(dev)
    t0 = time.perf_counter()
    fused_trips()
    host_issue = (time.perf_counter() - t0) * 1e3 / k

    t_eval = time_jitted(scan_eval, repeats=3, chain=1, device=dev)
    t_dir = time_jitted(scan_bookkeep, repeats=3, chain=1, device=dev)
    t_open = time_jitted(scan_open, repeats=3, chain=1, device=dev)
    t_full = time_jitted(full, repeats=3, chain=1, device=dev)
    max_evals = int(full().n_evals.max())
    k_evals = int(full_k().n_evals.max())
    # scan_open's window holds K K4 launches and the sum, fused_trips' 3 K
    # launches; the others' counts are not fixed in advance
    walls = [_wall_and_busy_ms(fn, dev, expect)
             for fn, expect in ((scan_eval, None), (scan_bookkeep, None),
                                (scan_open, k + 1), (full_k, None),
                                (fused_trips, 3 * k))]
    per = lambda ms, n: None if ms is None else ms / n
    work = opcount.cos_vg_work(transform(x_flat), rep(spots), rep(bs),
                               rep(bm), rep(bc), rep(bp), n_terms, "loss")
    eval_s = t_eval.steady_s / k
    return {
        "batch": b, "lanes": b * S,
        "eval_ms_per_trip": eval_s * 1e3,
        "bookkeep_ms_per_trip": t_dir.steady_s / k * 1e3,
        "full_solve_s": t_full.steady_s,
        "winner_max_evals": max_evals,
        "full_ms_per_eval": t_full.steady_s / max(max_evals, 1) * 1e3,
        "eval_gflops": work["ops"] / eval_s / 1e9,
        "eval_wall_ms_per_trip": per(walls[0][0], k),
        "eval_busy_ms_per_trip": per(walls[0][1], k),
        "bookkeep_wall_ms_per_trip": per(walls[1][0], k),
        "bookkeep_busy_ms_per_trip": per(walls[1][1], k),
        "open_ms_per_trip": t_open.steady_s / k * 1e3,
        "open_wall_ms_per_trip": per(walls[2][0], k),
        "open_busy_ms_per_trip": per(walls[2][1], k),
        "full_wall_ms_per_eval": per(walls[3][0], k_evals),
        "full_busy_ms_per_eval": per(walls[3][1], k_evals),
        "fused_host_ms_per_trip": host_issue,
        "fused_wall_ms_per_trip": per(walls[4][0], k),
        "fused_busy_ms_per_trip": per(walls[4][1], k),
        "open_profile_windows": walls[2][3],
        "fused_profile_windows": walls[4][3],
        **{f"{name}_kernels_per_{unit}": per(w[2], n)
           for name, unit, n, w in (
               ("eval", "trip", k, walls[0]),
               ("bookkeep", "trip", k, walls[1]),
               ("open", "trip", k, walls[2]),
               ("full", "eval", k_evals, walls[3]),
               ("fused", "trip", k, walls[4]))},
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="8,64,512,2048")
    ap.add_argument("--k", type=int, default=64, help="chained trips")
    ap.add_argument("--n-terms", type=int, default=64)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    results = []
    for b in [int(x) for x in args.batches.split(",")]:
        row = profile_batch(b, args.k, args.n_terms, dev)
        results.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                       "k": args.k, "n_terms": args.n_terms,
                       "results": results,
                       "launches": {**cos_kernel.LAUNCHES,
                                    **loss_kernel.LAUNCHES,
                                    **lb.LAUNCHES}}, f, indent=2)
    return results


if __name__ == "__main__":
    main()
