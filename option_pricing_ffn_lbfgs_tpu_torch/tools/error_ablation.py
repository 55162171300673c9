"""Error ablation on the benchmark sets (the JAX package's
``scripts/error_ablation.py``)::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.error_ablation \\
        --out ablation.json [--n-sets 6]

Runs the same fixed problem sets (``tools/bench.py::build_problems``,
seeds 2026 + i, 5 surfaces each) through ``calibrate_batch_mixed`` with 3
starts under five configurations and writes each one's mean, max, median
and per-surface error %:

  * ``default``;
  * ``uncapped_search``: no cap on the search's evaluations
    (``search_maxeval=0``);
  * ``search_N128``: the search prices at N = 128;
  * ``polish_winner_only``: only the float32 search winner is polished
    (``polish_all_starts=False``);
  * ``polish_N128``: the polish prices at N = 128.

``--out`` is required, so the JAX package's record
(``results/error_ablation.json``) is never overwritten. Runs on ``cuda``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ..utils.config import CalibrationConfig
from .bench import _require_cuda, build_problems, calibrate, errors_pct

_BASE = CalibrationConfig()
# name -> (config, polish_all_starts)
CONFIGS = {
    "default": (_BASE, True),
    "uncapped_search": (dataclasses.replace(_BASE, search_maxeval=0), True),
    "search_N128": (dataclasses.replace(_BASE, search_n_terms=128), True),
    "polish_winner_only": (_BASE, False),
    "polish_N128": (dataclasses.replace(_BASE, polish_n_terms=128), True),
}


def ablate(sets, configs=CONFIGS):
    """``{name: statistics}`` of each configuration over ``sets``
    (``build_problems``' list)."""
    rows = {}
    for name, (cfg, all_starts) in configs.items():
        e = np.concatenate([
            errors_pct(calibrate(args, "mixed", config=cfg,
                                 polish_all_starts=all_starts), truth)
            for args, truth in sets])
        rows[name] = {
            "mean_error_pct": round(float(e.mean()), 5),
            "max_error_pct": round(float(e.max()), 5),
            "median_error_pct": round(float(np.median(e)), 5),
            "per_surface_error_pct": [round(float(v), 5) for v in e],
        }
        print(json.dumps({name: rows[name]["mean_error_pct"]}), flush=True)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m option_pricing_ffn_lbfgs_tpu_torch.tools."
             "error_ablation")
    ap.add_argument("--n-sets", type=int, default=6)
    ap.add_argument("--out", required=True,
                    help="JSON file to write (no default: results/ holds "
                         "the JAX package's record)")
    args = ap.parse_args(argv)
    _require_cuda()
    payload = {
        "question": "what moves the benchmark's mean error: the search's "
                    "evaluation cap, its N = 64, the polish of every start "
                    "or the polish's N = 64?",
        "protocol": f"{args.n_sets} fixed problem sets x 5 surfaces, "
                    "identical across configs (tools/bench.py "
                    "build_problems, seeds 2026+i)",
        "device": torch.cuda.get_device_name(0),
        "configs": ablate(build_problems(args.n_sets)),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
