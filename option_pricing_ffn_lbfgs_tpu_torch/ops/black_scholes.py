"""Black–Scholes pricing and implied volatility, elementwise over tensors.

Port of the JAX package's ``ops/black_scholes.py``: the exact normal CDF
(``torch.special.ndtr``), and a safeguarded Newton implied-vol solver
whose bisection fallback keeps every iterate inside a bracket. JAX's
``lax.while_loop`` (which stops once every element is done) becomes
``max_iter`` masked iterations with no read from the device: an element
that is done freezes its iterate, and only the iterate is returned, so
the extra iterations change nothing.

Inputs broadcast against each other. Tensors keep their dtype; Python
numbers and numpy arrays count as float64 (numpy's rule, and JAX's under
x64); the result has the promoted dtype. ``device=None`` means the device
of a tensor input, else ``cuda``; a CPU run passes ``device="cpu"`` (or
CPU tensors).
"""
from __future__ import annotations

import math
from functools import reduce

import numpy as np
import torch
from torch.special import ndtr


def _tensors(*values, device=None):
    """``values`` as broadcast tensors of one floating dtype on one
    device."""
    if device is None:
        device = next((v.device for v in values
                       if isinstance(v, torch.Tensor)), "cuda")
    ts = [v.to(device) if isinstance(v, torch.Tensor)
          else torch.as_tensor(np.array(v, dtype=np.float64), device=device)
          for v in values]
    dt = reduce(torch.promote_types, (t.dtype for t in ts))
    return torch.broadcast_tensors(*(t.to(dt) for t in ts))


def _is_call(is_call, like):
    return torch.as_tensor(is_call, device=like.device).expand(like.shape)


def bs_price(spot, strike, tau, rate, vol, is_call=True, q=0.0,
             device=None):
    """Black–Scholes European option price. ``tau <= 0`` or ``vol <= 0``
    gives the discounted intrinsic value."""
    spot, strike, tau, vol = _tensors(spot, strike, tau, vol, device=device)
    sq = torch.sqrt(torch.clamp(tau, min=0.0))
    sig = torch.clamp(vol, min=1e-12) * torch.clamp(sq, min=1e-12)
    d1 = (torch.log(spot / strike) + (rate - q + 0.5 * vol * vol) * tau) / sig
    d2 = d1 - sig
    df_r = torch.exp(-rate * tau)
    df_q = torch.exp(-q * tau)
    call = spot * df_q * ndtr(d1) - strike * df_r * ndtr(d2)
    put = strike * df_r * ndtr(-d2) - spot * df_q * ndtr(-d1)
    is_call = _is_call(is_call, spot)
    price = torch.where(is_call, call, put)
    fwd = spot * df_q
    intrinsic = torch.where(is_call,
                            torch.clamp(fwd - strike * df_r, min=0.0),
                            torch.clamp(strike * df_r - fwd, min=0.0))
    return torch.where((tau <= 0.0) | (vol <= 0.0), intrinsic, price)


def bs_vega(spot, strike, tau, rate, vol, q=0.0, device=None):
    """dPrice/dVol (the same for calls and puts)."""
    spot, strike, tau, vol = _tensors(spot, strike, tau, vol, device=device)
    sq = torch.sqrt(torch.clamp(tau, min=1e-12))
    sig = torch.clamp(vol, min=1e-12) * sq
    d1 = (torch.log(spot / strike) + (rate - q + 0.5 * vol * vol) * tau) / sig
    pdf = torch.exp(-0.5 * d1 * d1) / math.sqrt(2.0 * math.pi)
    return spot * torch.exp(-q * tau) * pdf * sq


def implied_vol(price, spot, strike, tau, rate, is_call=True, q=0.0,
                lo: float = 1e-4, hi: float = 5.0, max_iter: int = 64,
                tol: float = 1e-10, device=None):
    """Implied Black–Scholes volatility by safeguarded Newton with a
    bisection fallback. NaN where no vol in ``[lo, hi]`` reproduces the
    price (a price below intrinsic or above the no-arbitrage bound)."""
    price, spot, strike, tau = _tensors(price, spot, strike, tau,
                                        device=device)
    is_call = _is_call(is_call, price)
    f = lambda v: bs_price(spot, strike, tau, rate, v, is_call, q) - price
    vlo = torch.full_like(price, lo)
    vhi = torch.full_like(price, hi)
    solvable = ((f(vlo) <= 0.0) & (f(vhi) >= 0.0) & (tau > 0.0)
                & (price > 0.0))
    v = torch.full_like(price, 0.2)
    done = torch.zeros_like(price, dtype=torch.bool)
    for _ in range(max_iter):
        fv = f(v)
        vega = bs_vega(spot, strike, tau, rate, v, q)
        newton = v - fv / torch.clamp(vega, min=1e-12)
        inside = (newton > vlo) & (newton < vhi) & torch.isfinite(newton)
        v_new = torch.where(inside, newton, 0.5 * (vlo + vhi))
        vlo = torch.where(fv < 0.0, v, vlo)
        vhi = torch.where(fv > 0.0, v, vhi)
        # A converged element freezes (at convergence Newton lands on a
        # bracket end, where ``inside`` would fire a bisection jump).
        done_new = done | (torch.abs(v_new - v) <= tol)
        v = torch.where(done, v, v_new)
        done = done_new
    return torch.where(solvable, v, torch.full_like(v, float("nan")))


def implied_vol_surface(prices, spot, strikes, maturities, rate,
                        is_call=True, q=0.0, device=None):
    """Implied vols of a whole surface in one solve."""
    return implied_vol(prices, spot, strikes, maturities, rate, is_call, q,
                       device=device)
