"""Error ablation on the benchmark sets (the JAX package's
``scripts/error_ablation.py``)::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.error_ablation \\
        --out ablation.json [--n-sets 6] [--starts torch|jax]

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

Starts: ``--starts torch`` (the default) draws each set's 3 starts from a
``torch.Generator`` seeded i (``tools/bench.py::calibrate``); ``--starts
jax`` takes them from ``tools/data/bench_jax_starts.npz``, the float32
starts JAX's ``bench.py`` draws from ``jax.random.key(i)`` (written and
held to JAX by ``tests/test_torch_jax_starts.py``), so every
configuration runs from the starts of the JAX package's record. With
``jax`` the tool also prints each surface's error beside the record's
``per_surface_error_pct`` (``results/error_ablation.json``, only read).

``--out`` is required, so the JAX package's record is never overwritten.
Runs on ``cuda``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ..utils.config import CalibrationConfig
from .bench import _require_cuda, build_problems, calibrate, errors_pct

JAX_STARTS = Path(__file__).resolve().parent / "data" / "bench_jax_starts.npz"
JAX_RECORD = (Path(__file__).resolve().parents[2] / "results"
              / "error_ablation.json")
_BASE = CalibrationConfig()
# name -> (config, polish_all_starts)
CONFIGS = {
    "default": (_BASE, True),
    "uncapped_search": (dataclasses.replace(_BASE, search_maxeval=0), True),
    "search_N128": (dataclasses.replace(_BASE, search_n_terms=128), True),
    "polish_winner_only": (_BASE, False),
    "polish_N128": (dataclasses.replace(_BASE, polish_n_terms=128), True),
}


def load_jax_starts():
    """The fixture's arrays: ``x0`` ``[6, 5, 3, 13]`` float32, ``truths``
    ``[6, 5, 13]``, ``prices`` ``[6, 5, 15]``."""
    with np.load(JAX_STARTS) as f:
        return {k: f[k] for k in f.files}


def ablate(sets, configs=CONFIGS, x0=None):
    """``{name: statistics}`` of each configuration over ``sets``
    (``build_problems``' list); ``x0``, if given, holds each set's
    ``[5, 3, 13]`` starts (else each set draws its own)."""
    rows = {}
    for name, (cfg, all_starts) in configs.items():
        e = np.concatenate([
            errors_pct(calibrate(
                args, "mixed", config=cfg, polish_all_starts=all_starts,
                **({} if x0 is None else {"x0": torch.as_tensor(
                    x0[i], device=args[4].device)})), truth)
            for i, (args, truth) in enumerate(sets)])
        rows[name] = {
            "mean_error_pct": round(float(e.mean()), 5),
            "max_error_pct": round(float(e.max()), 5),
            "median_error_pct": round(float(np.median(e)), 5),
            "per_surface_error_pct": [round(float(v), 5) for v in e],
        }
        print(json.dumps({name: rows[name]["mean_error_pct"]}), flush=True)
    return rows


def per_surface_table(rows, record):
    """Lines of each surface's error beside the record's, per configuration
    (``record``: the ``configs`` of ``results/error_ablation.json``)."""
    lines = []
    for name, row in rows.items():
        ours = row["per_surface_error_pct"]
        ref = record[name]["per_surface_error_pct"]
        lines.append(f"{name}: surface  port %  JAX record %")
        lines += [f"{name}: {j:7d}  {a:.5f}  {b:.5f}"
                  for j, (a, b) in enumerate(zip(ours, ref))]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m option_pricing_ffn_lbfgs_tpu_torch.tools."
             "error_ablation")
    ap.add_argument("--n-sets", type=int, default=6)
    ap.add_argument("--out", required=True,
                    help="JSON file to write (no default: results/ holds "
                         "the JAX package's record)")
    ap.add_argument("--starts", choices=("torch", "jax"), default="torch",
                    help="torch: a torch.Generator seeded i per set; jax: "
                         "JAX's own starts from tools/data/"
                         "bench_jax_starts.npz")
    args = ap.parse_args(argv)
    _require_cuda()
    x0 = None
    if args.starts == "jax":
        x0 = load_jax_starts()["x0"]
        if args.n_sets > len(x0):
            ap.error(f"--starts jax holds {len(x0)} sets")
    rows = ablate(build_problems(args.n_sets), x0=x0)
    payload = {
        "question": "what moves the benchmark's mean error: the search's "
                    "evaluation cap, its N = 64, the polish of every start "
                    "or the polish's N = 64?",
        "protocol": f"{args.n_sets} fixed problem sets x 5 surfaces, "
                    "identical across configs (tools/bench.py "
                    "build_problems, seeds 2026+i)",
        "device": torch.cuda.get_device_name(0),
        "configs": rows,
    }
    if args.starts == "jax":
        payload["starts"] = "jax: tools/data/bench_jax_starts.npz"
        with open(JAX_RECORD) as f:
            record = json.load(f)["configs"]
        for line in per_surface_table(rows, record):
            print(line)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
