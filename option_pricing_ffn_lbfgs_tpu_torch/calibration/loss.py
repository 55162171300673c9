"""Calibration objective: relative-MSE pricing error + Feller penalty.

Port of the JAX package's ``calibration/loss.py``, batched over a leading
lane axis: every function takes ``[L]`` parameter fields (or ``[L, 13]``
vectors) with ``[L, n]`` surfaces and returns one value per lane.

Sentinel semantics are kept: a lane with any non-finite or non-positive
model price gets ``config.bad_loss`` as a constant (no gradient flows
through it), and its residual vector is filled so that ``sum(r**2) ==
bad_loss``.
"""
from __future__ import annotations

import math

import torch

from ..models.double_heston import DHParams, price_options
from ..utils.config import CalibrationConfig
from .transforms import transform_to_params


def feller_penalty(params: DHParams, weight: float = 1000.0) -> torch.Tensor:
    """``weight * sum_f max(0, sigma_f^2 - 2 kappa_f theta_f)``."""
    zero = torch.zeros_like(params.sigma1)
    p1 = torch.maximum(zero, params.sigma1**2
                       - 2.0 * params.kappa1 * params.theta1)
    p2 = torch.maximum(zero, params.sigma2**2
                       - 2.0 * params.kappa2 * params.theta2)
    return weight * (p1 + p2)


def _model_prices(params, spot, rate, strikes, maturities, is_call, config):
    return price_options(params, spot, rate, strikes, maturities, is_call,
                         n_terms=config.pricer.n_terms, L=config.pricer.trunc_L,
                         q=config.pricer.dividend_yield)


def surface_loss(params: DHParams, spot, rate, strikes, maturities, is_call,
                 market_prices, config: CalibrationConfig = CalibrationConfig()):
    """Per-lane relative MSE + Feller penalty, NaN-safe: ``[L]``."""
    model = _model_prices(params, spot, rate, strikes, maturities, is_call,
                          config)
    return loss_from_prices(model, params, market_prices, config)


def loss_from_prices(model, params: DHParams, market_prices,
                     config: CalibrationConfig) -> torch.Tensor:
    """Loss assembly shared by ``surface_loss`` and the K1-priced loss of
    the calibrator's single-surface API: ``[L]``."""
    valid = torch.isfinite(model) & (model > 0.0)
    safe_model = torch.where(valid, model, market_prices)
    rel = (safe_model - market_prices) / market_prices
    mse = torch.mean(rel * rel, dim=-1)
    loss = mse + feller_penalty(params, config.feller_weight)
    bad = torch.full_like(loss, config.bad_loss).detach()
    loss = torch.where(torch.any(~valid, dim=-1), bad, loss)
    return torch.where(torch.isfinite(loss), loss, bad)


def feller_residuals(params: DHParams, weight: float) -> torch.Tensor:
    """``[..., 2]`` rows ``sqrt(weight * max(0, sigma_f^2 - 2 kappa_f
    theta_f))``; the sqrt kink is masked with a double where so the
    inactive branch differentiates cleanly."""
    viol = torch.stack([
        params.sigma1**2 - 2.0 * params.kappa1 * params.theta1,
        params.sigma2**2 - 2.0 * params.kappa2 * params.theta2], dim=-1)
    active = viol > 0.0
    safe_viol = torch.where(active, viol, torch.ones_like(viol))
    return torch.where(active, torch.sqrt(weight * safe_viol),
                       torch.zeros_like(viol))


def surface_residuals(params: DHParams, spot, rate, strikes, maturities,
                      is_call, market_prices,
                      config: CalibrationConfig = CalibrationConfig()):
    """The loss as residual vectors ``[L, n + 2]`` with
    ``sum(r**2, -1) == surface_loss``: n relative pricing errors / sqrt(n)
    followed by the two Feller rows."""
    model = _model_prices(params, spot, rate, strikes, maturities, is_call,
                          config)
    return residuals_from_prices(model, params, market_prices, config)


def residuals_from_prices(model, params: DHParams, market_prices,
                          config: CalibrationConfig) -> torch.Tensor:
    """Residual assembly shared by the plain path and the K1 polish path."""
    return residual_rows(model, params, market_prices, config.feller_weight,
                         config.bad_loss)


def residual_rows(model, params: DHParams, market_prices, weight: float,
                  bad_loss: float) -> torch.Tensor:
    """``[L, n + 2]``: the relative pricing errors over sqrt(n), then the
    Feller rows; every row ``sqrt(bad_loss / (n + 2))`` where a model price
    is not finite and positive."""
    valid = torch.isfinite(model) & (model > 0.0)
    safe_model = torch.where(valid, model, market_prices)
    n = market_prices.shape[-1]
    rel = (safe_model - market_prices) / market_prices / math.sqrt(n)
    r = torch.cat([rel, feller_residuals(params, weight)], dim=-1)
    bad = torch.full_like(r, math.sqrt(bad_loss / r.shape[-1]))
    return torch.where(torch.any(~valid, dim=-1, keepdim=True),
                       bad.detach(), r)


def make_residual_fn(spot, rate, strikes, maturities, is_call, market_prices,
                     config: CalibrationConfig = CalibrationConfig()):
    """Bind market data -> ``residuals(x: [L, 13]) -> [L, n + 2]``."""
    def residual_fn(x):
        return surface_residuals(transform_to_params(x), spot, rate, strikes,
                                 maturities, is_call, market_prices, config)
    return residual_fn


def make_loss_fn(spot, rate, strikes, maturities, is_call, market_prices,
                 config: CalibrationConfig = CalibrationConfig()):
    """Bind market data -> ``loss(x: [L, 13]) -> [L]``."""
    def loss_fn(x):
        return surface_loss(transform_to_params(x), spot, rate, strikes,
                            maturities, is_call, market_prices, config)
    return loss_fn
