"""Throughput scaling: surfaces per second against batch size on one card
(the JAX package's ``bench_scaling.py``)::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.bench_scaling \\
        [--batches 8,64,256,1024] [--modes f32,mixed] [--starts 3] \\
        [--sets 3] [--out FILE] [--device cuda]

For each (batch, mode) it prints one JSON line
``{"batch", "mode", "surfaces_per_s", "ms_per_surface", "mean_error_pct"}``.
``f32`` is ``calibrate_batch`` (the float32 search: K2, the winner
repriced by K1<float>), ``mixed`` is ``calibrate_batch_mixed`` (that
search, then the float64 LM polish of every start: K1<double>, K3).

Problems: ``--sets`` fresh sets per (batch, mode), set i seeded 7 + 10 i:
the generator's draws and AR(1) paths (``data/synthetic.py``: ``draw``
and ``ar1_paths``, Feller-capped) give the truths and spots, strikes keep
their moneyness (90-110 % of spot) over 3 maturities, and the noiseless
float64 all-call prices come from ``utils/hostpricer.py``; the starts
come from a CPU generator seeded 8 + 10 i. Timing: ``time_dispatches``,
the sets chained with one synchronize at the end (CUDA events), the median
of 3 trials; the error is the last set's mean relative error.

The port has one engine, so there is no ``--search-impl`` /
``--polish-impl``. ``--out`` has no default: the JAX package's record
(``results/scaling.json``) is never overwritten.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..calibration.calibrator import calibrate_batch, calibrate_batch_mixed
from ..data.synthetic import _surface_grid, ar1_paths, draw
from ..utils.config import CalibrationConfig, GeneratorConfig
from ..utils.hostpricer import price_truth_subprocess
from ..utils.timing import time_dispatches

RATE = 0.03


def build(b: int, seed: int, device):
    """One problem set of ``b`` surfaces: ``(spots, strikes, mats,
    is_call, prices, generator)``, float64 tensors on ``device``."""
    cfg = GeneratorConfig(n_samples=b)
    raw, z, _ = draw(b, torch.Generator().manual_seed(seed), torch.float64)
    params, spots = ar1_paths(raw, z, cfg)
    rel, mats = _surface_grid(cfg)
    spots = spots.numpy()
    strikes = spots[:, None] * rel[None, :] / 100.0
    mats = np.broadcast_to(mats, strikes.shape)
    prices = price_truth_subprocess(params.numpy(), spots, strikes, mats,
                                    RATE, device=device)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64,
                               device=device)
    return (t(spots), t(strikes), t(mats),
            torch.ones(strikes.shape, dtype=torch.bool, device=device),
            t(prices), seed + 1)


def run(batches, modes, n_starts=3, n_sets=3, device="cuda",
        config: CalibrationConfig = CalibrationConfig(), emit=print):
    """The sweep's rows; ``emit`` gets each row's JSON line."""
    dev = torch.device(device)
    rows = []
    for b in batches:
        for mode in modes:
            if mode not in ("f32", "mixed"):
                raise ValueError(f"mode must be f32 or mixed, got {mode!r}")
            inputs = [(build(b, 7 + 10 * i, dev),) for i in range(n_sets)]

            def go(a, mode=mode):
                gen = torch.Generator().manual_seed(a[5])
                if mode == "f32":
                    return calibrate_batch(a[0], RATE, *a[1:5], gen, config,
                                           n_starts=n_starts)
                return calibrate_batch_mixed(a[0], RATE, *a[1:5], gen,
                                             config, n_starts=n_starts)

            t = time_dispatches(go, inputs, repeats=3, device=dev)
            a = inputs[-1][0]
            out = go(a)
            mkt = a[4].cpu().numpy()
            rel = np.abs((out.model_prices.cpu().numpy().astype(np.float64)
                          - mkt) / mkt).mean() * 100
            row = {"batch": b, "mode": mode,
                   "surfaces_per_s": b / t.steady_s,
                   "ms_per_surface": t.steady_s / b * 1e3,
                   "mean_error_pct": float(rel)}
            rows.append(row)
            emit(json.dumps(row))
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="8,64,256,1024")
    ap.add_argument("--modes", default="f32,mixed")
    ap.add_argument("--starts", type=int, default=3)
    ap.add_argument("--sets", type=int, default=3,
                    help="fresh input sets chained per timing trial")
    ap.add_argument("--out", default=None, help="optional JSON file")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    cfg = CalibrationConfig()
    results = run([int(x) for x in args.batches.split(",")],
                  args.modes.split(","), args.starts, args.sets, dev, cfg,
                  emit=lambda line: print(line, flush=True))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                       "n_starts": args.starts,
                       "search_impl": cfg.search_impl,
                       "polish_impl": cfg.polish_impl,
                       "timing_protocol": "chained-fresh-inputs+" + (
                           "cuda-events" if dev.type == "cuda"
                           else "host-clock") + " (utils/timing.py)",
                       "results": results}, f, indent=2)
    return results


if __name__ == "__main__":
    main()
