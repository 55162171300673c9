"""How far the LM polish's outcome moves with the rounding of its float32
Jacobian, on the bench sets (``tools/bench.py``)::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.lm_spread \\
        [--sets 0,1,2,3,4,5,6,7] [--device cuda] [--out FILE]

For each set: the float32 search (``calibrate_batch`` as
``calibrate_batch_mixed`` runs it, on ``--device``), then the winners'
LM polish (``calibrator.POLISH_LM``, float64 residuals, float32
Jacobian) three ways from the same winners:

  * ``device``: on ``--device`` (on the card K1<double>, K3, K6, K7);
  * ``cpu``: on the CPU (their plain versions);
  * ``cpu_ulp``: on the CPU with the Jacobian taken one float32 ulp above
    the iterate (``torch.nextafter`` of ``x`` cast to float32): a change
    of the Jacobian's rounding only, of the size that parts K3 from its
    plain version.

Per surface it reports each run's error against the truth (%), its
iterations, which stopping test ended it (``stop_tests`` of
``ops/levenberg_marquardt.py``: gconv, fconv_accept, fconv_stall,
step_small, xconv_stall, tconv, give_up or maxiter) and the damping
there, and the largest relative difference of the model prices between
runs (``device`` vs ``cpu``, ``cpu`` vs ``cpu_ulp``). Where ``device``
and ``cpu`` end more than 1e-4 apart, it finds the first trip at which
their costs part by more than 1 % and compares, at the device run's
iterate before it, K3 and its plain version with the plain version at
float64 (``|J - J64|`` over ``max |J64|``, and the residual row where it
is largest: rows below n_opt price options, the last two are the Feller
rows), with each variance factor's ``sigma^2 - 2 kappa theta`` at the
iterate in float32 (on the device and on the CPU) and float64. One JSON
line a set.

Measurement only: no calibration path imports this module.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math

import numpy as np
import torch

from ..calibration import calibrator
from ..calibration.calibrator import calibrate_batch
from ..calibration.transforms import transform
from ..ops import levenberg_marquardt as lm
from ..ops.loss_kernel import FELLER_IDX, make_batch_residual_jacobian
from ..utils.config import CalibrationConfig, LMConfig, PricerConfig
from . import bench

F32, F64 = torch.float32, torch.float64
STOPS = ("gconv", "fconv_accept", "fconv_stall", "step_small",
         "xconv_stall", "tconv", "give_up", "maxiter")


def run_with_stops(residual_fn, jac_fn, x0: torch.Tensor, config: LMConfig):
    """The LM engine's loop (``levenberg_marquardt._run``) through its
    wrappers, recording for each lane the trip that ended it, the tests
    that fired there and the damping before it, and every trip's state
    ``x`` and cost: ``(state, stops, xs, costs)``."""
    r0 = residual_fn(x0)
    st = lm.init_state(x0, r0.shape[-1], config)
    status = torch.zeros(1, dtype=torch.int32, device=x0.device)
    stops = [None] * x0.shape[0]
    xs, costs = [], []
    first, live = True, x0.shape[0]
    while live:
        x_try = lm.lm_open(st, config, status)
        r_try = r0 if first else residual_fn(x_try)
        first = False
        before = lm._State(*(t.clone() for t in st))
        tests = lm.stop_tests(before, lm.trial_cost(r_try), config)
        tests["step_small"] = tests["step_small"] & tests["accept"]
        lm.lm_update(st, x_try, r_try, jac_fn(x_try).to(x0.dtype), config,
                     status)
        ended = (st.done & ~before.done).cpu()
        fired = {k: tests[k].cpu() for k in STOPS}
        for i in torch.nonzero(ended).flatten().tolist():
            stops[i] = {"iter": int(st.n_iters[i]),
                        "tests": [k for k in STOPS if bool(fired[k][i])],
                        "lam": float(before.lam[i])}
        xs.append(st.x.clone())
        costs.append(st.cost.clone())
        live = lm.read_live(status)
    return st, stops, xs, costs


def _polish(data, x, pcfg, device, nudge=False):
    """One polish of the winners ``x [B, 13]`` on ``device``."""
    d = [a.to(device) for a in data]
    residual_fn, jac_fn = calibrator.polish_residual_and_jacobian(
        d[0], bench.RATE, d[1], d[2], d[3], d[4], pcfg)
    if nudge:
        base = jac_fn
        up = lambda v: torch.nextafter(v, torch.full_like(v, math.inf))
        jac_fn = lambda v: base(up(v.to(F32)).to(F64))
    st, stops, xs, costs = run_with_stops(residual_fn, jac_fn,
                                          x.to(device), calibrator.POLISH_LM)
    n = d[4].shape[-1]
    model = d[4] * (1.0 + st.r[:, :n] * math.sqrt(n))
    return model.cpu(), stops, xs, costs


def _jacobian_gap(data, x_iter, pcfg, device):
    """K3 (on ``device``) and its plain version (CPU, float32) against the
    plain version at float64, at ``x_iter [1, 13]``: max |J - J64| over
    max |J64| and the row where it is largest; each factor's
    ``sigma^2 - 2 kappa theta`` at each precision."""
    def jac(dev, dt):
        d = [a.to(dev) for a in data]
        fn = make_batch_residual_jacobian(
            d[0].to(dt), d[1].to(dt), d[2].to(dt), d[3], d[4].to(dt),
            bench.RATE, pcfg)
        return fn(x_iter.to(dev, dt)).cpu().double()

    def feller(dev, dt):
        p = transform(x_iter.to(dev, dt)).cpu()
        return [float(p[0, s] * p[0, s] - 2.0 * p[0, k] * p[0, t])
                for s, k, t in FELLER_IDX]
    j64 = jac("cpu", F64)
    scale = float(j64.abs().max())
    out = {}
    for name, j in (("k3", jac(device, F32)), ("plain", jac("cpu", F32))):
        err = (j - j64).abs().amax(-1)[0]
        out[f"{name}_vs_f64"] = float(err.max()) / scale
        out[f"{name}_worst_row"] = int(err.argmax())
    out["feller_v"] = {"device_f32": feller(device, F32),
                       "cpu_f32": feller("cpu", F32),
                       "f64": feller("cpu", F64)}
    return out


def spread_set(i: int, device) -> dict:
    """One bench set's report (one JSON line)."""
    dev = torch.device(device)
    (args, truth), = [bench.build_problems(i + 1, device=dev)[i]]
    data = [a.cpu() for a in args[:5]]
    cfg = CalibrationConfig()
    search = dataclasses.replace(
        cfg, pricer=PricerConfig(n_terms=cfg.search_n_terms),
        lbfgs=dataclasses.replace(cfg.lbfgs, maxeval=cfg.search_maxeval))
    x = calibrate_batch(args[0], bench.RATE, *args[1:5],
                        torch.Generator().manual_seed(args[5]), search,
                        3).x.to(F64).cpu()
    pcfg = calibrator._polish_pricer_config(cfg)
    runs = {"device": _polish(data, x, pcfg, dev),
            "cpu": _polish(data, x, pcfg, "cpu"),
            "cpu_ulp": _polish(data, x, pcfg, "cpu", nudge=True)}
    err = lambda m: (np.abs(m.numpy() - truth) / truth).mean(-1) * 100.0
    rel = lambda a, b: ((runs[a][0] - runs[b][0]).abs()
                        / runs[b][0].abs()).amax(-1).tolist()
    report = {"set": i, "device": str(dev),
              "err_pct": {k: err(v[0]).tolist() for k, v in runs.items()},
              "stops": {k: v[1] for k, v in runs.items()},
              "rel_device_vs_cpu": rel("device", "cpu"),
              "rel_cpu_vs_cpu_ulp": rel("cpu", "cpu_ulp"), "parting": []}
    _, _, xs_d, c_d = runs["device"]
    _, _, _, c_c = runs["cpu"]
    for s, gap in enumerate(report["rel_device_vs_cpu"]):
        if gap <= 1e-4:
            continue
        trips = min(len(c_d), len(c_c))
        part = next((t for t in range(1, trips)
                     if abs(float(c_d[t][s]) - float(c_c[t][s]))
                     > 1e-2 * abs(float(c_c[t][s]))), None)
        if part is None:
            continue
        report["parting"].append({
            "surface": s, "trip": part,
            **_jacobian_gap([a[s:s + 1] for a in data],
                            xs_d[part - 1][s:s + 1].cpu(), pcfg, dev)})
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sets", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    rows = []
    for i in [int(s) for s in args.sets.split(",")]:
        rows.append(spread_set(i, args.device))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
