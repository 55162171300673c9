"""The two-stage surrogate training pipeline on the card (the JAX package's
``scripts/train_pipeline.py``)::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.train_pipeline \\
        --out-dir DIR [--n-pretrain 100000] [--n-finetune 1000] \\
        [--min-keep 100] [--device cuda]

  1. generate ``n_pretrain`` surfaces: draws from a seeded
     ``torch.Generator``, the host AR(1) paths (Feller-capped, as the JAX
     generator's ``sample_paths`` caps them), priced in float32 by
     K1<float> at N = 128, then the 2 % noise;
  2. generate ``n_finetune`` more the same way and calibrate them with
     ``calibrate_batch_mixed`` (3 starts on float64 inputs: K2, K3,
     K1<double>, K1<float>); the converged calibrations with finite
     parameters and finite loss below 1 are the fine-tune targets (at
     least ``min_keep`` of them), the calibrations are saved with
     ``save_batch_calibration``;
  3. pretrain (``TrainConfig()``), 4. fine-tune (``FINETUNE``) from it.

Writes, under the named output directory (there is no default, so the
shipped ``results/`` is never overwritten by accident):
``models/ffn_surrogate.pkl`` (the JAX pickle layout),
``data/scalers.pkl``, ``models/training_history.json`` (the JAX keys) and
``data/finetune_calibrations.npz`` (+ ``.meta.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import torch

from ..calibration.calibrator import calibrate_batch_mixed
from ..data.synthetic import SyntheticDataset, generate_dataset
from ..surrogate.scalers import save_scalers
from ..surrogate.train import (FINETUNE, TrainConfig, TrainedSurrogate,
                               dataset_to_xy, fit, save_surrogate)
from ..utils.checkpoint import save_batch_calibration
from ..utils.config import GeneratorConfig
from ..utils.timing import synchronize

PRETRAIN_SEED, FINETUNE_SEED, STARTS_SEED = 42, 43, 7


class PipelineResult(NamedTuple):
    surrogate: TrainedSurrogate   # the fine-tuned surrogate
    history: dict                 # what training_history.json holds
    stage_s: dict                 # wall seconds of each stage
    n_kept: int                   # fine-tune rows kept


def _gen(n: int, seed: int, dev: torch.device) -> SyntheticDataset:
    """n noisy surfaces priced in float32 by K1<float> at N = 128."""
    return generate_dataset(torch.Generator(dev).manual_seed(seed),
                            GeneratorConfig(n_samples=n),
                            dtype=torch.float32, n_terms=128, device=dev)


def train_pipeline(out_dir: str, n_pretrain: int = 100_000,
                   n_finetune: int = 1000, min_keep: int = 100,
                   device=None) -> PipelineResult:
    """Run the pipeline on ``device`` (default ``cuda``) and write its
    artefacts under ``out_dir``."""
    dev = torch.device(device if device is not None else "cuda")
    f32, f64 = torch.float32, torch.float64
    rate = GeneratorConfig().surface.rate
    stage_s = {}
    t_start = time.perf_counter()

    def stage(name, fn):
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        stage_s[name] = time.perf_counter() - t0
        return out

    print(f"[1/4] generating {n_pretrain} pretrain surfaces...", flush=True)
    pre = stage("generate", lambda: _gen(n_pretrain, PRETRAIN_SEED, dev))
    print(f"      done in {stage_s['generate']:.1f}s", flush=True)

    print(f"[2/4] calibrating {n_finetune} surfaces with the real L-BFGS "
          "engine (finetune targets)...", flush=True)

    def calibrate():
        fine = _gen(n_finetune, FINETUNE_SEED, dev)
        out = calibrate_batch_mixed(
            fine.spots.to(f64), rate, fine.strikes.to(f64),
            fine.maturities.to(f64),
            torch.ones(fine.strikes.shape, dtype=torch.bool, device=dev),
            fine.market_prices.to(f64),
            torch.Generator().manual_seed(STARTS_SEED), n_starts=3,
            device=dev)
        return fine, out
    fine, out = stage("calibrate", calibrate)
    market = fine.market_prices.to(f64)
    rel = ((out.model_prices - market) / market).abs()
    rel_pct = float(rel.mean()) * 100.0
    n_conv = int(out.converged.sum())
    # Fine-tune targets are what the calibrator returned, but only the
    # successful calibrations: a non-converged row's non-finite parameters
    # would turn every fine-tune minibatch it lands in to NaN.
    keep = (out.converged & torch.isfinite(out.params).all(dim=-1)
            & torch.isfinite(out.loss) & (out.loss < 1.0))
    n_keep = int(keep.sum())
    print(f"      calibrated: mean rel err vs noisy market {rel_pct:.4f}% "
          f"(noise floor ~2%), {n_conv}/{n_finetune} converged, "
          f"{stage_s['calibrate']:.1f}s", flush=True)
    print(f"      keeping {n_keep}/{n_finetune} converged+finite "
          "calibrations as finetune targets", flush=True)
    data_dir = os.path.join(out_dir, "data")
    models_dir = os.path.join(out_dir, "models")
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(models_dir, exist_ok=True)
    save_batch_calibration(
        os.path.join(data_dir, "finetune_calibrations.npz"), out,
        surface_ids=list(range(n_finetune)),
        metadata={"n_finetune": n_finetune, "n_kept": n_keep,
                  "n_starts": 3, "rate": rate})
    if n_keep < min_keep:
        raise RuntimeError(
            f"only {n_keep} usable finetune calibrations (at least "
            f"{min_keep} needed) — investigate before training")
    fine_calibrated = SyntheticDataset(
        params=out.params[keep].to(f32), spots=fine.spots[keep],
        strikes=fine.strikes[keep], maturities=fine.maturities[keep],
        model_prices=out.model_prices[keep].to(f32),
        market_prices=fine.market_prices[keep],
        losses=out.loss[keep].to(f32))

    print("[3/4] stage-1 pretraining...", flush=True)
    fx, fy = dataset_to_xy(pre)
    stage1, h1 = stage("pretrain",
                       lambda: fit(fx, fy, TrainConfig(), device=dev))
    print(f"      pretrain: {len(h1['val_loss'])} epochs, best val "
          f"{min(h1['val_loss']):.5f}, {stage_s['pretrain']:.1f}s",
          flush=True)

    print("[4/4] stage-2 fine-tuning on calibration results...", flush=True)
    gx, gy = dataset_to_xy(fine_calibrated)
    stage2, h2 = stage("finetune", lambda: fit(gx, gy, FINETUNE,
                                                init=stage1, device=dev))
    print(f"      finetune: {len(h2['val_loss'])} epochs, best val "
          f"{min(h2['val_loss']):.5f}, {stage_s['finetune']:.1f}s",
          flush=True)

    save_surrogate(os.path.join(models_dir, "ffn_surrogate.pkl"), stage2)
    save_scalers(os.path.join(data_dir, "scalers.pkl"),
                 stage2.feature_scaler, stage2.target_scaler)
    hist = {
        "pretrain": h1, "finetune": h2,
        "provenance": {
            "n_pretrain": n_pretrain,
            "n_finetune_calibrations": n_finetune,
            "finetune_targets": "actual L-BFGS calibration outputs "
                                "(calibrate_batch_mixed, 3 starts, f32 solve "
                                "+ f64 LM polish)",
            "finetune_calibration_mean_rel_err_vs_market_pct": rel_pct,
            "finetune_converged": n_conv,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "wall_s": round(time.perf_counter() - t_start, 1),
        },
    }
    with open(os.path.join(models_dir, "training_history.json"), "w") as f:
        json.dump(hist, f, indent=1)
    print(f"artifacts written to {models_dir} and {data_dir}; total "
          f"{time.perf_counter() - t_start:.1f}s", flush=True)
    return PipelineResult(stage2, hist, stage_s, n_keep)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m option_pricing_ffn_lbfgs_tpu_torch.tools."
             "train_pipeline")
    ap.add_argument("--out-dir", required=True,
                    help="directory for models/ and data/")
    ap.add_argument("--n-pretrain", type=int, default=100_000)
    ap.add_argument("--n-finetune", type=int, default=1000)
    ap.add_argument("--min-keep", type=int, default=100,
                    help="fewest usable fine-tune calibrations")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    train_pipeline(args.out_dir, args.n_pretrain, args.n_finetune,
                   args.min_keep, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
