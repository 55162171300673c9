"""Multi-start initial guesses, batched over surfaces.

Start i uses guess family ``i % 3`` (the JAX package's
``calibration/initial_guess.py``):
  0: literature values;
  1: type 0 with +/-20 % uniform noise (+/-15 % for rho/mu_j), rho clipped
     to [-0.95, -0.3]; the noise comes from a ``torch.Generator``, so it
     differs from JAX's draws for the same seed (tests inject JAX's x0);
  2: market-implied — rough ATM variance from near-the-money quotes.
Starts beyond 3 perturb their family's base vector like type 1.
All results are unconstrained (inverse-transformed) vectors.
"""
from __future__ import annotations

import numpy as np
import torch

from .transforms import inverse_transform

GUESS0 = np.array([0.04, 2.5, 0.04, 0.3, -0.7,
                   0.04, 0.5, 0.04, 0.2, -0.5,
                   0.15, -0.04, 0.08])
GUESS2_TEMPLATE = np.array([0.0, 2.0, 0.0, 0.4, -0.6,
                            0.0, 0.7, 0.0, 0.25, -0.4,
                            0.12, -0.03, 0.07])
_IMPLIED_VAR_SLOTS = [0, 2, 5, 7]
_NARROW_SLOTS = [4, 9, 11]
_RHO_SLOTS = [4, 9]


def implied_variance_estimate(spot, strikes, maturities, market_prices):
    """Rough ATM variance per surface from options with moneyness in
    (0.95, 1.05); 0.04 where a surface has no ATM quote. ``[...]``."""
    moneyness = strikes / spot[..., None]
    atm = (moneyness > 0.95) & (moneyness < 1.05)
    n_atm = atm.sum(-1).to(strikes.dtype)
    zero = torch.zeros_like(market_prices)
    denom = torch.clamp(n_atm, min=1.0)
    avg_price = torch.where(atm, market_prices, zero).sum(-1) / denom
    avg_tau = torch.where(atm, maturities, zero).sum(-1) / denom
    implied = (avg_price / spot) / torch.sqrt(torch.clamp(avg_tau, min=1e-12))
    implied = torch.clamp(implied, 0.01, 0.1)
    return torch.where(n_atm > 0, implied, torch.full_like(implied, 0.04))


def initial_guesses(n_starts: int, generator: torch.Generator, spot, strikes,
                    maturities, market_prices) -> torch.Tensor:
    """``[B, n_starts, 13]`` unconstrained starts for ``[B, n]`` surfaces,
    in the dtype and on the device of ``market_prices``."""
    return inverse_transform(initial_params(n_starts, generator, spot,
                                            strikes, maturities,
                                            market_prices))


def initial_params(n_starts: int, generator: torch.Generator, spot, strikes,
                   maturities, market_prices) -> torch.Tensor:
    """The starts of ``initial_guesses`` as constrained parameters."""
    dt, dev = market_prices.dtype, market_prices.device
    b = market_prices.shape[0]
    g0 = torch.as_tensor(GUESS0, dtype=dt, device=dev)
    iv = implied_variance_estimate(spot, strikes, maturities, market_prices)
    g2 = torch.as_tensor(GUESS2_TEMPLATE, dtype=dt, device=dev).repeat(b, 1)
    g2[:, _IMPLIED_VAR_SLOTS] = iv[:, None]
    family = torch.arange(n_starts, device=dev) % 3
    base = torch.where((family == 2)[None, :, None], g2[:, None, :],
                       g0.expand(b, n_starts, 13))             # [B, S, 13]
    scale = torch.full((13,), 0.20, dtype=dt, device=dev)
    scale[_NARROW_SLOTS] = 0.15
    noise = torch.rand((b, n_starts, 13), generator=generator, dtype=dt,
                       device=generator.device).to(dev) * 2.0 - 1.0
    perturbed = base * (1.0 + noise * scale)
    perturbed[..., _RHO_SLOTS] = perturbed[..., _RHO_SLOTS].clamp(-0.95, -0.3)
    noisy = (family == 1) | (torch.arange(n_starts, device=dev) >= 3)
    return torch.where(noisy[None, :, None], perturbed, base)
