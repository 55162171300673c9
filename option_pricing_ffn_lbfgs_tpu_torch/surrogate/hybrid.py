"""Hybrid FFN -> L-BFGS calibration, and the FFN-only screening mode.

The JAX package's ``surrogate/hybrid.py``: the FFN predicts the
calibrator's unconstrained coordinates, which warm-start the L-BFGS.

  * ``hybrid_calibrate``: one surface at the dtype of its prices, the
    documented pipeline (FFN start, then a 10-iteration L-BFGS refine),
    run by the batched engine on one lane with K2 (float32) or K2<double>
    (float64) as its value-and-grad;
  * ``hybrid_calibrate_batch_mixed``: the batch fast path. The FFN start
    and the literature type-0 guess (the safeguard against an FFN start in
    a bad basin) are refined together in float32 by ``calibrate_batch``
    (K2 on B x 2 lanes at ``config.pricer.n_terms``); the winner of each
    surface alone is then polished at float64 by the batched
    Levenberg-Marquardt (K1<double> residuals, the float32 K3 Jacobian)
    at ``config.polish_n_terms``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..calibration.calibrator import (
    POLISH_LM, WAVE_LANES, BatchCalibration, _device_of, _inputs,
    _polish_lanes_fused, _polish_pricer_config, _winner, calibrate_batch,
    surface_loss_k1)
from ..calibration.initial_guess import GUESS0
from ..calibration.transforms import inverse_transform, transform
from ..ops.cos_kernel import price_surfaces
from ..ops.lbfgs_batched import lbfgs_minimize_batched
from ..ops.loss_kernel import make_batch_value_and_grad
from ..utils import tracing
from ..utils.config import CalibrationConfig, validate_calibration
from .train import TrainedSurrogate


class HybridResult(NamedTuple):
    x: torch.Tensor              # refined unconstrained params [13]
    params: torch.Tensor         # refined constrained params [13]
    loss: torch.Tensor
    model_prices: torch.Tensor
    ffn_params: torch.Tensor     # the raw FFN prediction (constrained)
    ffn_loss: torch.Tensor       # loss at the FFN prediction
    iterations: torch.Tensor


def ffn_only_predict(surrogate: TrainedSurrogate, market_prices, spot):
    """FFN-only screening mode: surface -> constrained parameter vector."""
    return surrogate.predict_params(market_prices, spot)


def hybrid_calibrate(surrogate: TrainedSurrogate, spot, rate: float, strikes,
                     maturities, is_call, market_prices,
                     config: CalibrationConfig = CalibrationConfig(),
                     refine_maxiter: int = 10, device=None) -> HybridResult:
    """One surface ``[n_opt]``: FFN warm start + ``refine_maxiter``
    L-BFGS iterations at ``config.pricer.n_terms``, at the dtype of
    ``market_prices``, on ``device`` (default: the device of
    ``market_prices`` if it is a tensor, else ``cuda``)."""
    dev = _device_of(market_prices, device)
    mkt = torch.as_tensor(market_prices)
    dt = mkt.dtype
    one = lambda a: torch.as_tensor(a)[None]
    spots, strikes, maturities, is_call, mkt = _inputs(
        torch.as_tensor(spot).reshape(1), one(strikes), one(maturities),
        one(is_call), mkt[None], dt, dev)
    x0 = surrogate.predict_x(mkt, spots).to(dt)                  # [1, 13]
    vg = make_batch_value_and_grad(spots, strikes, maturities, is_call, mkt,
                                   rate, config)
    cfg = dataclasses.replace(config.lbfgs, maxiter=refine_maxiter)
    res = lbfgs_minimize_batched(vg, x0, cfg)
    params = transform(res.x)
    pc = config.pricer
    model = price_surfaces(params, spots, rate, strikes, maturities, is_call,
                           n_terms=pc.n_terms, L=pc.trunc_L,
                           q=pc.dividend_yield)
    ffn_params = transform(x0)
    ffn_loss = surface_loss_k1(ffn_params, spots, rate, strikes, maturities,
                               is_call, mkt, config)
    return HybridResult(x=res.x[0], params=params[0], loss=res.f[0],
                        model_prices=model[0], ffn_params=ffn_params[0],
                        ffn_loss=ffn_loss[0], iterations=res.n_iters[0])


@tracing.entry_point
def hybrid_calibrate_batch_mixed(surrogate: TrainedSurrogate, spots,
                                 rate: float, strikes, maturities, is_call,
                                 market_prices,
                                 config: CalibrationConfig = CalibrationConfig(),
                                 refine_maxiter: int = 40,
                                 safeguard_start: bool = True,
                                 polish=None, device=None) -> BatchCalibration:
    """Batch hybrid over ``[B, n_opt]`` surfaces: FFN warm start (plus the
    type-0 safeguard start) -> float32 L-BFGS refine -> float64 LM polish
    of each surface's refine winner.

    ``device`` defaults to the device of ``market_prices`` if it is a
    tensor, else ``cuda``. Returns a ``BatchCalibration``: ``per_start_x``
    holds the float32 refine iterates with the winner's row replaced by
    its polished iterate, ``per_start_loss`` the refine losses;
    ``iterations`` and ``n_evals`` add the winner's refine and polish
    counts; ``converged`` is the polish's or the refine's flag. It runs
    no compacted waves: ``calibrator.WAVE_LANES`` is left empty.
    """
    if polish is None:
        polish = POLISH_LM
    validate_calibration(config, polish)
    WAVE_LANES.clear()
    f32, f64 = torch.float32, torch.float64
    dev = _device_of(market_prices, device)
    spots32, _, _, _, mkt32 = _inputs(spots, strikes, maturities, is_call,
                                      market_prices, f32, dev)
    with tracing.span("ffn"):
        x0 = surrogate.predict_x(mkt32, spots32).to(f32)          # [B, 13]
        b = x0.shape[0]
        if safeguard_start:
            g0 = inverse_transform(torch.as_tensor(GUESS0, dtype=f32,
                                                   device=dev))
            x0 = torch.stack([x0, g0.expand(b, 13)], dim=1)       # [B, 2, 13]
        else:
            x0 = x0[:, None, :]                                   # [B, 1, 13]
    refine_config = dataclasses.replace(
        config, lbfgs=dataclasses.replace(config.lbfgs,
                                          maxiter=refine_maxiter))
    out32 = calibrate_batch(spots, rate, strikes, maturities, is_call,
                            market_prices, None, refine_config, x0.shape[1],
                            x0, dev)

    _, win = _winner(out32.per_start_loss)
    spots, strikes, maturities, is_call, mkt = _inputs(
        spots, strikes, maturities, is_call, market_prices, f64, dev)
    with tracing.span("polish.winner"):
        res, params_vec, model = _polish_lanes_fused(
            spots, rate, strikes, maturities, is_call, mkt, out32.x.to(f64),
            None, _polish_pricer_config(config), polish)
    per_start_x = out32.per_start_x.to(f64)
    per_start_x[torch.arange(b, device=dev), win] = res.x
    return BatchCalibration(
        x=res.x, params=params_vec, loss=res.f, model_prices=model,
        iterations=out32.iterations + res.n_iters,
        n_evals=out32.n_evals + res.n_evals,
        converged=res.converged | out32.converged,
        per_start_loss=out32.per_start_loss.to(f64), per_start_x=per_start_x)
