"""The double-float pricer as an oracle for K1<double> on the card::

    python -m option_pricing_ffn_lbfgs_tpu_torch.tools.dd_check [--n 200]

``models/double_heston_dd.py`` prices from float32 operations alone, so it
shares none of K1<double>'s float64 units. This tool prices ``--n``
surfaces drawn over the generator's market ranges (15 calls each: 5
strikes x 3 maturities, N = 128) with the DD pricer on the card and with
K1<double>, and measures:

  * the relative difference, median and worst (every DD price finite);
  * the DD prices on the card against the DD prices on the CPU;
  * the golden demo call (SURVEY 6.1: 13.872851144174323) in DD;
  * the sigma_J = 0.25, tau = 0.1 case (the jump CF's exponent ~ -28600,
    below exp's underflow cliff) in DD against K1<double>;
  * the DD pricer's wall against K1<double>'s on the same options (CUDA
    events), for information.

``run`` returns the numbers; ``chip_smoke.py`` phase 17 checks them. The
tool runs on ``cuda``; ``run(device="cpu", timing=False)`` runs both
sides through the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..models.double_heston import DHParams
from ..models.double_heston_dd import price_options_dd
from ..ops.cos_kernel import price_surfaces
from ..utils.timing import cuda_time_ms
from .bench import MATS, RANGES, STRIKES

GOLDEN_CALL = 13.872851144174323
DEMO = dict(v1_0=0.04, kappa1=2.0, theta1=0.04, sigma1=0.3, rho1=-0.5,
            v2_0=0.04, kappa2=1.5, theta2=0.04, sigma2=0.2, rho2=-0.3,
            lambda_j=0.5, mu_j=-0.05, sigma_j=0.10)
SIGMA_J_CASE = [0.04, 2.5, 0.04, 0.3, -0.7, 0.04, 0.5, 0.04, 0.2, -0.5,
                0.15, -0.04, 0.25]


def draws(n: int, seed: int = 17) -> np.ndarray:
    """``[n, 13]`` uniform draws over the generator's market ranges."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(lo, hi, n) for lo, hi in RANGES.values()],
                    axis=-1)


def surfaces(v: np.ndarray, device):
    """``price_options_dd``'s arguments for the 15-call grid of each row of
    ``v`` on ``device``."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                  device=device)
    n = len(v)
    return (DHParams.from_vector(t(v)), t(np.full(n, 100.0)), 0.03,
            t(np.tile(STRIKES, (n, 1))), t(np.tile(MATS, (n, 1))),
            torch.ones((n, 15), dtype=torch.bool, device=device))


def k1_prices(args):
    """K1<double> on ``surfaces``' arguments (N = 128)."""
    return price_surfaces(args[0].to_vector(), *args[1:], n_terms=128)


def run(n: int = 200, device="cuda", timing: bool = True) -> dict:
    """The numbers above for ``n`` surfaces priced on ``device`` (the CPU
    side of "card vs CPU" is always the CPU; ``timing`` needs a card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dd_check: no CUDA card")
    v = draws(n)
    args = surfaces(v, dev)
    dd = price_options_dd(*args)
    k1 = k1_prices(args)
    dd_cpu = price_options_dd(*surfaces(v, "cpu"))
    rel_k1 = (dd / k1 - 1).abs()
    rel_cpu = (dd.cpu() / dd_cpu - 1).abs()
    demo = price_options_dd(
        DHParams.from_dict(DEMO, device=dev), 100.0, 0.05,
        torch.tensor([100.0, 100.0], dtype=torch.float64, device=dev),
        torch.tensor([1.0, 1.0], dtype=torch.float64, device=dev),
        torch.tensor([True, False], device=dev))
    one = lambda a: torch.tensor([a], dtype=torch.float64, device=dev)
    sj = (DHParams.from_vector(one(SIGMA_J_CASE)), one(100.0), 0.03,
          one([100.0]), one([0.1]),
          torch.ones((1, 1), dtype=torch.bool, device=dev))
    sj_dd, sj_k1 = price_options_dd(*sj).item(), k1_prices(sj).item()
    out = {
        "n_surfaces": n,
        "shape": list(dd.shape),
        "all_finite": bool(torch.isfinite(dd).all()),
        "vs_k1_median": rel_k1.median().item(),
        "vs_k1_worst": rel_k1.max().item(),
        "card_vs_cpu_median": rel_cpu.median().item(),
        "card_vs_cpu_worst": rel_cpu.max().item(),
        "golden_call": demo[0].item(),
        "golden_put": demo[1].item(),
        "sigma_j_dd": sj_dd,
        "sigma_j_k1": sj_k1,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if timing:
        out["dd_ms"] = cuda_time_ms(lambda: price_options_dd(*args),
                                    repeats=3, warmup=1)
        out["k1_ms"] = cuda_time_ms(lambda: k1_prices(args))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m option_pricing_ffn_lbfgs_tpu_torch.tools.dd_check")
    ap.add_argument("--n", type=int, default=200)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
