"""dh13-mixed: the mixed-precision multi-start calibrator, as the
reference's headline protocol runs it (15 calls, 5 strikes x 3
maturities, 3 starts) and as the repo's pipeline deploys it.

``calibrate_batch_mixed`` with the default ``CalibrationConfig``, every
field that shapes the work stated here: a float32 multi-start L-BFGS
search at N = 64 (at most 160 evaluations a lane), then a float64 LM
polish of every start at N = 64, in a stage A of 10 iterations and
compacted waves of 16, 24 and 48 iterations when a call has at least 64
lanes. The 3 starts of each surface are the program's
(``initial_guesses``: literature, perturbed, market-implied), drawn once
for the pool from a ``torch.Generator`` on the card seeded with the
pool's seed and passed as ``x0``, so that a surface is the same problem
whichever call takes it.

The control is the program's own lower-precision path: the float32
search alone (``calibrate_batch`` at float32, the same search settings
and starts, the winner repriced at float32), with no float64 polish.
"""
from __future__ import annotations

import dataclasses

import torch

import option_pricing_ffn_lbfgs_tpu_torch as port

SOURCE = ("https://github.com/zenthepen/Option-Pricing-FFN-LBFGS "
          "README.md:14-18 (15 calls: 5 strikes x 3 maturities, 3 starts)")
SETTINGS = {
    "entry": "calibrate_batch_mixed",
    "n_starts": 3,
    "trunc_L": 10.0,
    "dividend_yield": 0.0,
    "feller_weight": 1000.0,
    "bad_loss": 1e10,
    "search_n_terms": 64,
    "search_maxeval": 160,
    "lbfgs": {"maxiter": 300, "history": 10, "ftol": 1e-9, "gtol": 1e-6,
              "wolfe_c1": 1e-4, "wolfe_c2": 0.9, "max_linesearch": 20,
              "max_restarts": 2},
    "polish_n_terms": 64,
    "polish_lm": {"maxiter": 80, "ftol": 1e-15, "gtol": 1e-11,
                  "cost_target": 1e-10},
    "polish_stage_a_maxiter": 10,
    "polish_compact_min_lanes": 64,
    "polish_wave_budgets": [16, 24, 48],
    "polish_continue_margin": 30.0,
}
# Nothing is assumed beyond the reference: every value above is the
# port's default, which is the JAX package's.
ASSUMED = {}
# The COS terms of each K2/K3 launch mode on this path.
KERNEL_TERMS = {"loss": SETTINGS["search_n_terms"],
                "jac": SETTINGS["polish_n_terms"]}
# Lanes a surface of each K2/K3 launch mode: the search's (or refine's)
# starts, and the polish's first run of LM trips.
LANES_PER_SURFACE = {"loss": SETTINGS["n_starts"],
                     "jac": SETTINGS["n_starts"]}
# The reference's settings for judging the outputs: the polish's.
CHECK_PRICER = {"n_terms": SETTINGS["polish_n_terms"],
                "L": SETTINGS["trunc_L"],
                "feller_weight": SETTINGS["feller_weight"],
                "bad_loss": SETTINGS["bad_loss"]}
# Every start's returned loss and x are polished ones.
PER_START_POLISHED = True


def calibration_config(s=SETTINGS) -> port.CalibrationConfig:
    return port.CalibrationConfig(
        pricer=port.PricerConfig(trunc_L=s["trunc_L"],
                                 dividend_yield=s["dividend_yield"]),
        lbfgs=port.LBFGSConfig(**s["lbfgs"]),
        feller_weight=s["feller_weight"], bad_loss=s["bad_loss"],
        search_n_terms=s["search_n_terms"],
        search_maxeval=s["search_maxeval"],
        polish_n_terms=s["polish_n_terms"],
        polish_stage_a_maxiter=s["polish_stage_a_maxiter"],
        polish_compact_min_lanes=s["polish_compact_min_lanes"],
        polish_wave_budgets=tuple(s["polish_wave_budgets"]),
        polish_continue_margin=s["polish_continue_margin"])


def prepare(device, pool, seed):
    """What every call shares: the configuration, the polish and every
    surface's starts."""
    dev = torch.device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    starts = port.initial_guesses(SETTINGS["n_starts"], generator,
                                  pool.spots, pool.strikes, pool.maturities,
                                  pool.market)
    return {"config": calibration_config(),
            "polish": port.LMConfig(**SETTINGS["polish_lm"]),
            "starts": starts, "device": dev}


def _args(batch):
    return (batch["spots"], batch["rate"], batch["strikes"],
            batch["maturities"], batch["is_call"], batch["market"])


def calibrate(ctx, batch):
    """The timed call: one batch through the port's public entry."""
    out = port.calibrate_batch_mixed(
        *_args(batch), config=ctx["config"], n_starts=SETTINGS["n_starts"],
        polish=ctx["polish"], x0=ctx["starts"][batch["idx"]],
        device=ctx["device"])
    return out._asdict()


def control(ctx, batch):
    """The float32 search alone, on the same inputs and starts."""
    cfg = ctx["config"]
    search = dataclasses.replace(
        cfg, pricer=dataclasses.replace(cfg.pricer,
                                        n_terms=cfg.search_n_terms),
        lbfgs=dataclasses.replace(cfg.lbfgs, maxeval=cfg.search_maxeval))
    out = port.calibrate_batch(*_args(batch), config=search,
                               n_starts=SETTINGS["n_starts"],
                               x0=ctx["starts"][batch["idx"]],
                               device=ctx["device"], dtype=torch.float32)
    return out._asdict()
