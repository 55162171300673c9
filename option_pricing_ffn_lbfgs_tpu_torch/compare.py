"""Method comparison: FFN-only vs pure L-BFGS vs hybrid.

The JAX package's ``compare.py`` with the same protocol and the same
artefacts (``lbfgs_actual_results.json``, ``hybrid_actual_results.json``,
``COMPARISON_TABLE.txt``). For each evaluation surface, calibrate against
its noiseless model prices with:
  * FFN-only screening (one forward pass, then K1 repricing);
  * pure multi-start L-BFGS (``calibrate_batch_mixed``: float32 search,
    float64 LM polish);
  * hybrid FFN warm start + float32 refine + float64 LM polish.

Timing is per sample: after a batch-of-1 warm-up, every surface is
calibrated alone and timed by the host clock after
``torch.cuda.synchronize()`` (on a CUDA device), so the per-sample arrays
are n distinct measurements. The batched run (all surfaces in one call)
is recorded under "batched".
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from .calibration.calibrator import calibrate_batch_mixed
from .data.synthetic import SyntheticDataset
from .ops.cos_kernel import price_surfaces
from .surrogate.hybrid import hybrid_calibrate_batch_mixed
from .surrogate.train import TrainedSurrogate
from .utils.config import CalibrationConfig
from .utils.results import summarize, write_comparison_table
from .utils.timing import synchronize


def _mean_err_pct(model, market):
    model, market = np.asarray(model), np.asarray(market)
    return np.abs((model - market) / market).mean(axis=-1) * 100.0


def _time_each(fn, n, device):
    """Run ``fn(i)`` per sample: (results, per-sample seconds)."""
    outs, times = [], []
    for i in range(n):
        synchronize(device)
        t0 = time.perf_counter()
        outs.append(fn(i))
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return outs, np.asarray(times)


def _timed(fn, device):
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def run_comparison(ds: SyntheticDataset, surrogate: TrainedSurrogate,
                   n_eval: int = 5, rate: float = 0.03,
                   config: CalibrationConfig = CalibrationConfig(),
                   n_starts: int = 6, out_dir: Optional[str] = None,
                   device=None) -> dict:
    """Run the three-method comparison on the first ``n_eval`` surfaces of
    ``ds`` on ``device`` (default: the dataset's device).

    ``n_starts`` defaults to 6, as in the JAX package. Sample ``i``'s
    L-BFGS starts come from ``torch.Generator().manual_seed(i)``; the
    batched run draws from ``manual_seed(0)``.
    """
    dev = torch.device(device) if device is not None else ds.spots.device
    n = min(n_eval, ds.n_samples)
    market = ds.model_prices[:n].to(dev)          # noiseless protocol
    spots, strikes, mats = (a[:n].to(dev)
                            for a in (ds.spots, ds.strikes, ds.maturities))
    is_call = torch.ones(strikes.shape, dtype=torch.bool, device=dev)
    market_np = market.cpu().numpy()
    pc = config.pricer
    gen = lambda i: torch.Generator().manual_seed(i)
    sl = lambda a, i: a[i:i + 1]

    # --- FFN-only (per sample): forward pass + K1 repricing ---
    def ffn_one(i):
        pvec = surrogate.predict_params(sl(market, i), sl(spots, i))
        return price_surfaces(pvec.to(market.dtype), sl(spots, i), rate,
                              sl(strikes, i), sl(mats, i), sl(is_call, i),
                              n_terms=pc.n_terms, L=pc.trunc_L,
                              q=pc.dividend_yield)
    ffn_one(0)                                         # warm-up (B=1)
    ffn_outs, ffn_times = _time_each(ffn_one, n, dev)
    ffn_model = torch.cat(ffn_outs).cpu().numpy()
    ffn_errors = _mean_err_pct(ffn_model, market_np)

    # --- pure L-BFGS (mixed precision, per sample) ---
    def lbfgs_one(i):
        return calibrate_batch_mixed(
            sl(spots, i), rate, sl(strikes, i), sl(mats, i), sl(is_call, i),
            sl(market, i), gen(i), config, n_starts=n_starts)
    lbfgs_one(0)                                       # warm-up (B=1)
    lbfgs_outs, lbfgs_times = _time_each(lbfgs_one, n, dev)
    cat = lambda outs, f: torch.cat([getattr(o, f) for o in outs]).cpu().numpy()
    lbfgs_errors = _mean_err_pct(cat(lbfgs_outs, "model_prices"), market_np)
    lbfgs_iters = cat(lbfgs_outs, "iterations")
    lbfgs_conv = cat(lbfgs_outs, "converged")

    # --- hybrid (per sample). The FFN phase is timed separately per
    # sample; lbfgs_times is the remainder (refine + polish), so total =
    # ffn + lbfgs by construction, the reference's phase decomposition.
    def hybrid_one(i):
        return hybrid_calibrate_batch_mixed(
            surrogate, sl(spots, i), rate, sl(strikes, i), sl(mats, i),
            sl(is_call, i), sl(market, i), config)

    def ffn_phase_one(i):
        return surrogate.predict_x(sl(market, i), sl(spots, i))
    hybrid_one(0)                                      # warm-up (B=1)
    ffn_phase_one(0)
    hybrid_outs, hybrid_total_times = _time_each(hybrid_one, n, dev)
    _, hybrid_ffn_times = _time_each(ffn_phase_one, n, dev)
    hybrid_ffn_times = np.minimum(hybrid_ffn_times, hybrid_total_times)
    hybrid_lbfgs_times = hybrid_total_times - hybrid_ffn_times
    hybrid_errors = _mean_err_pct(cat(hybrid_outs, "model_prices"),
                                  market_np)
    improvements = 100.0 * (1.0 - hybrid_errors / ffn_errors)

    # --- batched run: all n surfaces in one call, after a warm-up ---
    run_lbfgs_b = lambda: calibrate_batch_mixed(
        spots, rate, strikes, mats, is_call, market, gen(0), config,
        n_starts=n_starts)
    run_hybrid_b = lambda: hybrid_calibrate_batch_mixed(
        surrogate, spots, rate, strikes, mats, is_call, market, config)
    _timed(run_lbfgs_b, dev)
    lbfgs_batched = _timed(run_lbfgs_b, dev)[1] / n
    _timed(run_hybrid_b, dev)
    hybrid_batched = _timed(run_hybrid_b, dev)[1] / n

    batched_note = ("per-surface wall clock with all surfaces calibrated "
                    f"in one batched call (amortized over the batch of {n})")
    payload = {
        "lbfgs": {
            **summarize(lbfgs_errors, lbfgs_times, lbfgs_iters, lbfgs_conv),
            "timing_note": "total_times are individually measured "
                           "per-surface calibrations (batch of 1)",
            "batched": {"time_per_surface": lbfgs_batched,
                        "note": batched_note},
        },
        "hybrid": {
            "pricing_errors": hybrid_errors.tolist(),
            "ffn_times": hybrid_ffn_times.tolist(),
            "lbfgs_times": hybrid_lbfgs_times.tolist(),
            "total_times": hybrid_total_times.tolist(),
            "ffn_errors": ffn_errors.tolist(),
            "improvements": improvements.tolist(),
            "statistics": {
                "mean_error": float(hybrid_errors.mean()),
                "std_error": float(hybrid_errors.std()),
                "median_error": float(np.median(hybrid_errors)),
                "min_error": float(hybrid_errors.min()),
                "max_error": float(hybrid_errors.max()),
                "mean_time": float(hybrid_total_times.mean()),
                "std_time": float(hybrid_total_times.std()),
                "mean_improvement": float(improvements.mean()),
            },
            "timing_note": "total_times and ffn_times are individually "
                           "measured per surface; lbfgs_times is their "
                           "difference (refine + polish phases)",
            "batched": {"time_per_surface": hybrid_batched,
                        "note": batched_note},
        },
        "ffn": {"mean_error": float(ffn_errors.mean()),
                "mean_time": float(ffn_times.mean())},
    }

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "lbfgs_actual_results.json"), "w") as f:
            json.dump(payload["lbfgs"], f, indent=2)
        with open(os.path.join(out_dir, "hybrid_actual_results.json"), "w") as f:
            json.dump(payload["hybrid"], f, indent=2)
        write_comparison_table(
            os.path.join(out_dir, "COMPARISON_TABLE.txt"),
            [dict(name="FFN-Only", mean_error_pct=float(ffn_errors.mean()),
                  mean_time_s=float(ffn_times.mean()), samples=n),
             dict(name="Pure L-BFGS",
                  mean_error_pct=float(lbfgs_errors.mean()),
                  mean_time_s=float(lbfgs_times.mean()), samples=n),
             dict(name="Hybrid (FFN->L-BFGS)",
                  mean_error_pct=float(hybrid_errors.mean()),
                  mean_time_s=float(hybrid_total_times.mean()), samples=n)])
    return payload
