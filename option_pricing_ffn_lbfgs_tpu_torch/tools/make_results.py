"""The comparison artefacts from the shipped surrogate (the JAX package's
``scripts/make_results.py``)::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.make_results \\
        [--n-eval 10] [--seed 42] [--out-dir compare_results] \\
        [--surrogate results/models/ffn_surrogate.pkl] [--device cuda]

Draws ``--n-eval`` surfaces' parameter and spot paths (``data/synthetic.py``:
``draw`` and ``ar1_paths`` at float32, from a CPU generator seeded
``--seed``), prices their noiseless float64 targets with
``utils/hostpricer.py``, and runs ``compare.py::run_comparison`` (FFN-only,
pure L-BFGS, hybrid) with the trained surrogate. It writes
``lbfgs_actual_results.json``, ``hybrid_actual_results.json`` and
``COMPARISON_TABLE.txt`` to ``--out-dir``, which defaults to the
git-ignored ``compare_results/``: the JAX package's record in ``results/``
is never overwritten.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..compare import run_comparison
from ..data.synthetic import SyntheticDataset, _surface_grid, ar1_paths, draw
from ..surrogate.predict import DEFAULT_MODEL_PATH
from ..surrogate.train import load_surrogate
from ..utils.config import GeneratorConfig
from ..utils.hostpricer import price_truth_subprocess

OUT_DIR = "compare_results"


def build_dataset(n: int, seed: int, device) -> SyntheticDataset:
    """``n`` noiseless surfaces (market = model prices), float64 tensors
    on ``device``."""
    dev = torch.device(device)
    cfg = GeneratorConfig(n_samples=n)
    raw, z, _ = draw(n, torch.Generator().manual_seed(seed), torch.float32)
    params, spots = ar1_paths(raw, z, cfg)
    rel, mats = _surface_grid(cfg)
    spots32 = spots.numpy()
    strikes = (spots32[:, None] * rel[None, :].astype(np.float32)
               / np.float32(100.0)).astype(np.float64)   # as JAX, in f32
    params, spots = params.numpy().astype(np.float64), spots32.astype(
        np.float64)
    b_mats = np.broadcast_to(mats, strikes.shape)
    truth = price_truth_subprocess(params, spots, strikes, b_mats,
                                   rate=cfg.surface.rate, device=dev)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64,
                               device=dev)
    model_prices = t(truth)
    return SyntheticDataset(params=t(params), spots=t(spots),
                            strikes=t(strikes), maturities=t(b_mats),
                            model_prices=model_prices,
                            market_prices=model_prices,   # noiseless
                            losses=torch.zeros(n, dtype=torch.float64,
                                               device=dev))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-eval", type=int, default=10)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--surrogate", default=DEFAULT_MODEL_PATH)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    ds = build_dataset(args.n_eval, args.seed, dev)
    payload = run_comparison(ds, load_surrogate(args.surrogate),
                             n_eval=args.n_eval,
                             rate=GeneratorConfig().surface.rate,
                             out_dir=args.out_dir, device=dev)
    print(json.dumps({
        "ffn_mean_error_pct": payload["ffn"]["mean_error"],
        "lbfgs": payload["lbfgs"]["statistics"],
        "hybrid": payload["hybrid"]["statistics"],
        "lbfgs_batched_s": payload["lbfgs"]["batched"]["time_per_surface"],
        "hybrid_batched_s": payload["hybrid"]["batched"]["time_per_surface"],
    }, indent=1))
    return payload


if __name__ == "__main__":
    main()
