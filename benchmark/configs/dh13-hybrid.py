"""dh13-hybrid: the documented FFN -> L-BFGS serving path, with the
surrogate the repo ships.

``hybrid_calibrate_batch_mixed`` with the default ``CalibrationConfig``,
every field that shapes the work stated here: the shipped FFN
(``results/models/ffn_surrogate.pkl``, loaded by the port) predicts a
start, which with the literature start (the safeguard) goes through the
float32 L-BFGS refine (at most 40 iterations, N = 128); each surface's
refine winner is polished at float64 by the LM at N = 64. No generator:
the starts come from the surfaces.

The control is the program's own lower-precision path: the same two
starts through the float32 refine alone (``calibrate_batch`` at float32
with the refine's settings, the winner repriced at float32), with no
float64 polish.
"""
from __future__ import annotations

import dataclasses

import torch

import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch.calibration.initial_guess import (
    GUESS0)

SOURCE = ("https://github.com/zenthepen/Option-Pricing-FFN-LBFGS "
          "results/hybrid_actual_results.json (FFN warm start, L-BFGS "
          "refine)")
SETTINGS = {
    "entry": "hybrid_calibrate_batch_mixed",
    "surrogate": "results/models/ffn_surrogate.pkl",
    "safeguard_start": True,
    "refine_maxiter": 40,
    "refine_n_terms": 128,
    "trunc_L": 10.0,
    "dividend_yield": 0.0,
    "feller_weight": 1000.0,
    "bad_loss": 1e10,
    "lbfgs": {"history": 10, "ftol": 1e-9, "gtol": 1e-6, "wolfe_c1": 1e-4,
              "wolfe_c2": 0.9, "max_linesearch": 20, "max_restarts": 2},
    "polish_n_terms": 64,
    "polish_lm": {"maxiter": 80, "ftol": 1e-15, "gtol": 1e-11,
                  "cost_target": 1e-10},
}
ASSUMED = {}
KERNEL_TERMS = {"loss": SETTINGS["refine_n_terms"],
                "jac": SETTINGS["polish_n_terms"]}
# Lanes a surface of each K2/K3 launch mode: the refine's starts, and the
# polish's one run of LM trips over the winners.
LANES_PER_SURFACE = {"loss": 2 if SETTINGS["safeguard_start"] else 1,
                     "jac": 1}
# The reference's settings for judging the outputs: the polish's.
CHECK_PRICER = {"n_terms": SETTINGS["polish_n_terms"],
                "L": SETTINGS["trunc_L"],
                "feller_weight": SETTINGS["feller_weight"],
                "bad_loss": SETTINGS["bad_loss"]}
# Only the winner is polished; the other starts' losses are the refine's.
PER_START_POLISHED = False


def calibration_config(s=SETTINGS) -> port.CalibrationConfig:
    return port.CalibrationConfig(
        pricer=port.PricerConfig(n_terms=s["refine_n_terms"],
                                 trunc_L=s["trunc_L"],
                                 dividend_yield=s["dividend_yield"]),
        lbfgs=port.LBFGSConfig(**s["lbfgs"]),
        feller_weight=s["feller_weight"], bad_loss=s["bad_loss"],
        polish_n_terms=s["polish_n_terms"])


def prepare(device, pool, seed):
    """The surrogate on the card, the configuration and the polish (the
    starts come from the surfaces)."""
    del pool, seed
    dev = torch.device(device)
    surrogate = port.load_default_model()
    surrogate.module(dev)
    return {"surrogate": surrogate, "config": calibration_config(),
            "polish": port.LMConfig(**SETTINGS["polish_lm"]), "device": dev}


def _args(batch):
    return (batch["spots"], batch["rate"], batch["strikes"],
            batch["maturities"], batch["is_call"], batch["market"])


def calibrate(ctx, batch):
    """The timed call: one batch through the port's public entry."""
    out = port.hybrid_calibrate_batch_mixed(
        ctx["surrogate"], *_args(batch), config=ctx["config"],
        refine_maxiter=SETTINGS["refine_maxiter"],
        safeguard_start=SETTINGS["safeguard_start"], polish=ctx["polish"],
        device=ctx["device"])
    return out._asdict()


def control(ctx, batch):
    """The float32 refine alone, from the hybrid's two starts."""
    f32 = torch.float32
    cfg = ctx["config"]
    spots = batch["spots"].to(f32)
    x0 = ctx["surrogate"].predict_x(batch["market"].to(f32), spots).to(f32)
    if SETTINGS["safeguard_start"]:
        g0 = port.inverse_transform(torch.as_tensor(GUESS0, dtype=f32,
                                                    device=x0.device))
        x0 = torch.stack([x0, g0.expand_as(x0)], dim=1)
    else:
        x0 = x0[:, None, :]
    refine = dataclasses.replace(
        cfg, lbfgs=dataclasses.replace(cfg.lbfgs,
                                       maxiter=SETTINGS["refine_maxiter"]))
    out = port.calibrate_batch(*_args(batch), config=refine,
                               n_starts=LANES_PER_SURFACE["loss"], x0=x0,
                               device=ctx["device"], dtype=f32)
    return out._asdict()
