"""Plain float64 reference: the Double Heston + Merton COS pricer, the
parameter transform and the Feller-penalised relative-MSE loss.

Written once from the published model (Fang and Oosterlee's COS method
over the product of two Heston characteristic functions and a Merton
jump factor) with the formulas and quirks of the port's
``models/double_heston.py`` and ``calibration/loss.py``, and frozen here:
it imports nothing of the program, runs on native ``complex128`` where the
program splits real and imaginary parts, and is what the benchmark prices
its truths with and judges the program's outputs by.

Kept quirks of the model being calibrated (they are part of its prices):
``r * tau`` counted once per variance factor in the first cumulant; the
truncation range widened to ``log(K / S0) -/+ 0.1``; the k = 0 term
half-weighted; the k = 0 payoff coefficients at their limits.

Parameter vectors are ``[..., 13]`` in the order of ``PARAM_NAMES``.
"""
from __future__ import annotations

import math

import torch

PARAM_NAMES = ("v1_0", "kappa1", "theta1", "sigma1", "rho1",
               "v2_0", "kappa2", "theta2", "sigma2", "rho2",
               "lambda_j", "mu_j", "sigma_j")
EXP_IDX = (0, 1, 2, 3, 5, 6, 7, 8, 10, 12)
TANH_IDX = (4, 9)
# (sigma, kappa, theta) of each variance factor.
FELLER_IDX = ((3, 1, 2), (8, 6, 7))


def transform(x: torch.Tensor) -> torch.Tensor:
    """Unconstrained ``[..., 13]`` -> parameters: exp for the positive
    ones, tanh for the correlations, identity for the jump mean."""
    out = x.clone()
    out[..., EXP_IDX] = torch.exp(x[..., EXP_IDX])
    out[..., TANH_IDX] = torch.tanh(x[..., TANH_IDX])
    return out


def feller_violation(params: torch.Tensor) -> torch.Tensor:
    """``[..., 2]``: ``sigma_f^2 - 2 kappa_f theta_f`` of each factor."""
    return torch.stack([params[..., s] ** 2
                        - 2.0 * params[..., k] * params[..., t]
                        for s, k, t in FELLER_IDX], dim=-1)


def _cumulants(tau, rate, v0, kappa, theta, sigma, rho):
    e1 = torch.exp(-kappa * tau)
    c1 = rate * tau + (1.0 - e1) * (theta - v0) / (2.0 * kappa) \
        - theta * tau / 2.0
    c2 = (1.0 / (8.0 * kappa ** 3)) * (
        sigma * tau * kappa * e1 * (v0 - theta) * (8.0 * kappa * rho
                                                   - 4.0 * sigma)
        + kappa * rho * sigma * (1.0 - e1) * (16.0 * theta - 8.0 * v0)
        + 2.0 * theta * kappa * tau * (-4.0 * kappa * rho * sigma
                                       + sigma ** 2 + 4.0 * kappa ** 2)
        + sigma ** 2 * ((theta - 2.0 * v0) * torch.exp(-2.0 * kappa * tau)
                        + theta * (6.0 * e1 - 7.0) + 2.0 * v0)
        + 8.0 * kappa ** 2 * (v0 - theta) * (1.0 - e1))
    return c1, c2


def _heston_exponent(u, tau, v0, kappa, theta, sigma, rho):
    """One factor's ``A + B v0`` at real frequencies ``u`` (complex)."""
    xi = kappa - 1j * rho * sigma * u
    d = torch.sqrt(xi * xi + sigma ** 2 * (u * u + 1j * u))
    g = (xi - d) / (xi + d)
    e = torch.exp(-d * tau)
    b = (xi - d) / sigma ** 2 * (1.0 - e) / (1.0 - g * e)
    a = kappa * theta / sigma ** 2 * (
        (xi - d) * tau - 2.0 * torch.log((1.0 - g * e) / (1.0 - g)))
    return a + b * v0


def _price_block(p, spots, rate, strikes, mats, is_call, n_terms, L):
    col = lambda i: p[:, i, None, None]                       # [B, 1, 1]
    s0 = spots[:, None, None]
    tau = mats[..., None]                                      # [B, n, 1]
    strike = strikes[..., None]
    c1a, c2a = _cumulants(tau, rate, col(0), col(1), col(2), col(3), col(4))
    c1b, c2b = _cumulants(tau, rate, col(5), col(6), col(7), col(8), col(9))
    lam, mu, sj = col(10), col(11), col(12)
    c1 = c1a + c1b + lam * tau * mu
    c2 = c2a + c2b + lam * tau * (sj ** 2 + mu ** 2)
    log_k = torch.log(strike / s0)
    a = torch.minimum(c1 - L * torch.sqrt(torch.abs(c2)), log_k - 0.1)
    b = torch.maximum(c1 + L * torch.sqrt(torch.abs(c2)), log_k + 0.1)
    k = torch.arange(n_terms, dtype=torch.float64, device=p.device)
    u = k * math.pi / (b - a)                                  # [B, n, N]

    expo = (_heston_exponent(u, tau, col(0), col(1), col(2), col(3), col(4))
            + _heston_exponent(u, tau, col(5), col(6), col(7), col(8),
                               col(9))
            + 1j * (rate - lam * (torch.exp(mu + 0.5 * sj ** 2) - 1.0))
            * u * tau
            + lam * tau * (torch.exp(-0.5 * sj ** 2 * u * u + 1j * u * mu)
                           - 1.0))
    phi = torch.exp(expo)

    call = is_call[..., None]
    lo = torch.where(call, log_k, a)
    hi = torch.where(call, b, log_k)
    first = k == 0
    us = torch.where(first, torch.ones_like(u), u)
    ehi, elo = torch.exp(hi), torch.exp(lo)
    cos_h, cos_l = torch.cos(us * (hi - a)), torch.cos(us * (lo - a))
    sin_h, sin_l = torch.sin(us * (hi - a)), torch.sin(us * (lo - a))
    chi = torch.where(first, ehi - elo,
                      (cos_h * ehi - cos_l * elo
                       + us * (sin_h * ehi - sin_l * elo)) / (1.0 + us * us))
    psi = torch.where(first, hi - lo, (sin_h - sin_l) / us)
    v = 2.0 / (b - a) * torch.where(call, s0 * chi - strike * psi,
                                    strike * psi - s0 * chi)
    terms = (phi * torch.exp(-1j * u * a)).real * v
    terms = torch.where(first, 0.5 * terms, terms)
    return torch.exp(-rate * mats) * terms.sum(-1)


def price(params, spots, rate: float, strikes, maturities, is_call,
          n_terms: int = 128, L: float = 10.0,
          block: int = 2048) -> torch.Tensor:
    """European prices ``[B, n]`` of ``params [B, 13]`` on ``[B, n]``
    strikes, maturities and call flags, spots ``[B]``, in float64 on the
    device of ``params``, ``block`` surfaces at a time."""
    f64 = torch.float64
    dev = params.device
    t = lambda a: torch.as_tensor(a, dtype=f64, device=dev)
    params, spots, strikes, maturities = (
        t(params), t(spots), t(strikes), t(maturities))
    is_call = torch.as_tensor(is_call, dtype=torch.bool, device=dev)
    out = torch.empty(strikes.shape, dtype=f64, device=dev)
    for i in range(0, params.shape[0], block):
        j = slice(i, i + block)
        out[j] = _price_block(params[j], spots[j], rate, strikes[j],
                              maturities[j], is_call[j], n_terms, L)
    return out


def loss(model, params, market, feller_weight: float = 1000.0,
         bad_loss: float = 1e10) -> torch.Tensor:
    """``[B]``: mean squared relative pricing error plus ``feller_weight``
    times each factor's positive Feller violation; ``bad_loss`` where a
    model price is not finite and positive, or the loss is not finite."""
    valid = torch.isfinite(model) & (model > 0.0)
    rel = (torch.where(valid, model, market) - market) / market
    value = (rel * rel).mean(-1) + feller_weight * torch.clamp(
        feller_violation(params), min=0.0).sum(-1)
    bad = ~valid.all(-1) | ~torch.isfinite(value)
    return torch.where(bad, torch.full_like(value, bad_loss), value)
