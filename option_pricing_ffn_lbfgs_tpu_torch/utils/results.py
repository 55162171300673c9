"""Result containers and results-JSON schema writers (numpy only).

A mirror of the JAX package's ``utils/results.py``: ``CalibrationResult``
has the same fields, so a pickled list of them written by either package
loads in the other (``convert.load_pickle`` maps the class across), and
``summarize`` / ``write_benchmark_json`` / ``write_comparison_table`` emit
the same JSON keys and table as the reference's ``results/*.json`` and
``results/COMPARISON_TABLE.txt``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class CalibrationResult:
    """Container for one calibration outcome (reference-compatible)."""
    date: str
    spot: float
    risk_free: float
    parameters: Dict[str, float]
    market_prices: np.ndarray
    model_prices: np.ndarray
    market_options: List[Dict]
    final_loss: float
    calibration_time: Optional[float] = None   # None for synthetic data
    success: bool = True
    iterations: Optional[int] = None           # None for synthetic data
    message: str = ""

    @property
    def mean_rel_error_pct(self) -> float:
        """Mean |model - market| / market in percent."""
        rel = np.abs((np.asarray(self.model_prices) - np.asarray(self.market_prices))
                     / np.asarray(self.market_prices))
        return float(np.mean(rel) * 100.0)


def summarize(errors, times, iterations, successes) -> dict:
    errors = np.asarray(errors, dtype=float)
    times = np.asarray(times, dtype=float)
    return {
        "pricing_errors": errors.tolist(),
        "total_times": times.tolist(),
        "iterations": [int(i) for i in iterations],
        "success_count": int(np.sum(successes)),
        "statistics": {
            "mean_error": float(np.mean(errors)),
            "std_error": float(np.std(errors)),
            "median_error": float(np.median(errors)),
            "mean_time": float(np.mean(times)),
            "std_time": float(np.std(times)),
            "median_time": float(np.median(times)),
            "success_rate": float(np.mean(np.asarray(successes, dtype=float))),
        },
    }


def write_benchmark_json(path, errors, times, iterations, successes, extra=None):
    """Write the reference benchmark-results schema to ``path``."""
    payload = summarize(errors, times, iterations, successes)
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    return payload


def write_comparison_table(path, rows):
    """ASCII comparison table in the spirit of results/COMPARISON_TABLE.txt.

    ``rows``: list of dicts with keys name, mean_error_pct, mean_time_s,
    samples.
    """
    lines = ["=" * 100, "CALIBRATION METHOD COMPARISON", "=" * 100, ""]
    header = f"| {'Method':<22} | {'Mean Error (%)':>16} | {'Mean Time (s)':>16} | {'Samples':>8} |"
    lines += [header, "|" + "-" * (len(header) - 2) + "|"]
    for r in rows:
        lines.append(
            f"| {r['name']:<22} | {r['mean_error_pct']:>15.4f}% | "
            f"{r['mean_time_s']:>15.4f}s | {r['samples']:>8} |")
    lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))
