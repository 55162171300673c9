"""Does the training path repeat its outcome from one process to the next?

    python3 -m option_pricing_ffn_lbfgs_tpu_torch.tools.train_repeat
        [--runs 2]

Each run is a fresh process (``--one``) on the card that does what
``chip_smoke.py``'s phase 14 does up to its hybrid check:
``tools/train_pipeline.py`` at its published size (100,000 pretraining
surfaces, 1,000 fine-tune calibrations) into a temporary directory, then
the saved surrogate served by ``hybrid_calibrate_batch_mixed`` on 512
held-out noiseless surfaces (generator seed 2027), beside its FFN-only
errors. It prints one JSON line: the saved surrogate's sha256, the rows
kept for fine-tuning, the rows ``fit()`` dropped as non-finite (its
warnings), the best pretraining validation loss, sha256 of the hybrid's
and the FFN-only per-surface errors, and the margin of each check that
phase 14 makes on them (rows kept >= 100, best val < 1, every surface
beating FFN-only, the hybrid's mean <= 0.03 %). The parent prints the
runs' lines and which fields differ between them.

Measurement only: no calibration path imports this module.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

N_HELD, HELD_SEED = 512, 2027


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def one_run() -> dict:
    """The pipeline and the hybrid check in this process, on the card."""
    from .. import generate_dataset, hybrid_calibrate_batch_mixed
    from .. import load_surrogate
    from ..ops.cos_kernel import price_surfaces
    from ..utils.config import GeneratorConfig
    from .train_pipeline import train_pipeline

    dev = torch.device("cuda")
    f64 = torch.float64
    warnings = []

    class Dropped(logging.Handler):
        def emit(self, rec):
            warnings.append(rec.getMessage())
    log = logging.getLogger(
        "option_pricing_ffn_lbfgs_tpu_torch.surrogate.train")
    handler = Dropped()
    log.addHandler(handler)
    with tempfile.TemporaryDirectory() as tmp:
        res = train_pipeline(tmp, n_pretrain=100_000, n_finetune=1000,
                             device=dev)
        log.removeHandler(handler)
        pkl = os.path.join(tmp, "models", "ffn_surrogate.pkl")
        with open(pkl, "rb") as f:
            saved = hashlib.sha256(f.read()).hexdigest()[:16]
        surrogate = load_surrogate(pkl)
    held = generate_dataset(torch.Generator(dev).manual_seed(HELD_SEED),
                            GeneratorConfig(n_samples=N_HELD), dtype=f64,
                            device=dev)
    call = torch.ones((N_HELD, 15), dtype=torch.bool, device=dev)
    truth = held.model_prices
    out = hybrid_calibrate_batch_mixed(surrogate, held.spots, 0.03,
                                       held.strikes, held.maturities, call,
                                       truth)
    err = lambda m: (((m - truth).abs() / truth).mean(-1).cpu().numpy()
                     * 100)
    h_err = err(out.model_prices)
    p_ffn = surrogate.predict_params(truth, held.spots).to(f64)
    ffn = err(price_surfaces(p_ffn, held.spots, 0.03, held.strikes,
                             held.maturities, call))
    gap = ffn - h_err
    best_pre = min(res.history["pretrain"]["val_loss"])
    return {
        "device": torch.cuda.get_device_name(0),
        "surrogate_sha256": saved, "n_kept": res.n_kept,
        "fit_warnings": warnings, "best_pretrain_val": best_pre,
        "hybrid_err_sha256": _sha(h_err), "ffn_err_sha256": _sha(ffn),
        "hybrid_mean_pct": float(h_err.mean()),
        "margins": {
            "n_kept >= 100": res.n_kept - 100,
            "best pretrain val < 1": 1.0 - best_pre,
            "every surface beats FFN-only": float(gap.min()),
            "hybrid mean <= 0.03 %": 0.03 - float(h_err.mean()),
        },
        "closest_surface": int(np.argmin(gap)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python3 -m option_pricing_ffn_lbfgs_tpu_torch.tools."
             "train_repeat")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--one", action="store_true",
                    help="one run in this process (the parent's child)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_repeat needs a CUDA card")
    if args.one:
        print(json.dumps(one_run()), flush=True)
        return 0
    lines = []
    for k in range(args.runs):
        proc = subprocess.run(
            [sys.executable, "-m", __spec__.name, "--one"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {k} failed with exit {proc.returncode}")
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"[run {k}] {json.dumps(lines[-1])}", flush=True)
    differ = sorted(key for key in lines[0]
                    if any(ln[key] != lines[0][key] for ln in lines[1:]))
    print(json.dumps({"runs": len(lines), "fields_that_differ": differ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
