"""Calibration on raw reference-range parameter draws (the JAX package's
``scripts/bench_raw_draws.py``)::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.bench_raw_draws \\
        --out FILE [--n 20] [--seed 404] [--starts 6] [--device cuda]

The truths are uniform draws over the reference generator's raw ranges
(``RAW_RANGES``, verbatim), with no Feller cap, so Feller-violating truths
are kept; the noiseless float64 all-call prices on the 5 strikes x 3
maturities grid come from ``utils/hostpricer.py``. ``calibrate_batch_mixed``
(float32 search, float64 LM polish of every start) calibrates them with
``--starts`` starts from a CPU generator seeded ``--seed``: a first call
(``compile_s``: its wall, the kernels' nvcc build or load included, where
JAX had its compile) and a second one (``steady_s_per_surface``), each
timed by the host clock after a synchronize. It writes the per-surface
error, the Feller flags and the converged flags with the JAX file's keys,
and prints the statistics. ``--out`` is required, so the JAX package's
record (``results/raw_draws_bench.json``) is never overwritten.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..calibration.calibrator import calibrate_batch_mixed
from ..utils.hostpricer import price_truth_subprocess
from ..utils.timing import synchronize

RAW_RANGES = {  # synthetic_generator.py:75-89, verbatim
    "v1_0": (0.025, 0.080), "kappa1": (1.5, 4.5), "theta1": (0.025, 0.065),
    "sigma1": (0.20, 0.50), "rho1": (-0.85, -0.40),
    "v2_0": (0.020, 0.070), "kappa2": (0.30, 1.20), "theta2": (0.025, 0.070),
    "sigma2": (0.10, 0.35), "rho2": (-0.70, -0.20),
    "lambda_j": (0.05, 0.25), "mu_j": (-0.08, -0.01), "sigma_j": (0.03, 0.12),
}


def run(n: int = 20, seed: int = 404, n_starts: int = 6,
        device="cuda") -> dict:
    """The payload of the JAX driver's file, computed on ``device``."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    true = np.stack([rng.uniform(lo, hi, n)
                     for lo, hi in RAW_RANGES.values()], axis=-1)
    names = list(RAW_RANGES)
    i = {k: names.index(k) for k in names}
    feller_violated = (
        (true[:, i["sigma1"]] ** 2
         > 2 * true[:, i["kappa1"]] * true[:, i["theta1"]])
        | (true[:, i["sigma2"]] ** 2
           > 2 * true[:, i["kappa2"]] * true[:, i["theta2"]]))

    strikes = np.tile(np.tile([90.0, 95.0, 100.0, 105.0, 110.0], 3), (n, 1))
    mats = np.tile(np.repeat([0.25, 0.5, 1.0], 5), (n, 1))
    prices = price_truth_subprocess(true, np.full(n, 100.0), strikes, mats,
                                    device=dev)
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    args = (t(np.full(n, 100.0)), t(strikes), t(mats),
            torch.ones((n, 15), dtype=torch.bool, device=dev), t(prices))

    def go():
        out = calibrate_batch_mixed(args[0], 0.03, *args[1:],
                                    torch.Generator().manual_seed(seed),
                                    n_starts=n_starts)
        synchronize(dev)
        return out

    synchronize(dev)
    t0 = time.perf_counter()
    go()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = go()
    steady_s = time.perf_counter() - t0

    rel = np.abs((out.model_prices.cpu().numpy() - prices) / prices)
    per_surface_pct = rel.mean(axis=-1) * 100.0
    ok = ~feller_violated
    return {
        "protocol": ("raw reference-range uniform draws, NO Feller "
                     "enforcement (synthetic_generator.py:75-89); "
                     "noiseless f64 targets; mixed-precision calibration, "
                     f"{n_starts} starts"),
        "n_surfaces": n,
        "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "per_surface_error_pct": per_surface_pct.tolist(),
        "feller_violated_truth": feller_violated.tolist(),
        "converged": out.converged.cpu().numpy().tolist(),
        "statistics": {
            "mean_error_pct": float(per_surface_pct.mean()),
            "median_error_pct": float(np.median(per_surface_pct)),
            "p90_error_pct": float(np.percentile(per_surface_pct, 90)),
            "max_error_pct": float(per_surface_pct.max()),
            "mean_error_pct_feller_ok": float(per_surface_pct[ok].mean())
            if ok.any() else None,
            "mean_error_pct_feller_violated": float(
                per_surface_pct[feller_violated].mean())
            if feller_violated.any() else None,
            "n_feller_violated": int(feller_violated.sum()),
            "steady_s_per_surface": steady_s / n,
            "compile_s": compile_s,
        },
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--seed", type=int, default=404)
    ap.add_argument("--starts", type=int, default=6)
    ap.add_argument("--out", required=True,
                    help="JSON file to write (required: the JAX record in "
                    "results/ stays as it is)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    payload = run(args.n, args.seed, args.starts, args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload["statistics"], indent=1))
    return payload


if __name__ == "__main__":
    main()
