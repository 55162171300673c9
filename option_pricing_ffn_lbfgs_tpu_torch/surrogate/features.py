"""Option-surface feature extraction for the FFN surrogate.

The JAX package's ``surrogate/features.py`` on tensors: for the standard
maturity-major 5-strike x 3-maturity call surface (strikes 90/95/100/105/110
% moneyness),
  per maturity tau (3 maturities x 3 features):
    atm    = P_ATM / S0                       (normalized ATM price)
    skew   = (P_OTM - P_ITM) / S0             (OTM call K=110, ITM call K=90)
    fly    = (P_ITM + P_OTM - 2 P_ATM) / S0   (convexity / butterfly)
  cross-maturity (2):
    slope  = (P_ATM(1Y) - P_ATM(3M)) / S0     (term-structure slope)
    total  = sum_tau P_ATM(tau) / S0          (total ATM premium)
"""
from __future__ import annotations

import torch

N_FEATURES = 11
_N_STRIKES = 5
_N_MATURITIES = 3
_ITM, _ATM, _OTM = 0, 2, 4   # indices of K=90/100/110 within a maturity block


def extract_features(market_prices, spot) -> torch.Tensor:
    """``[..., 15]`` maturity-major prices + spot (``[...]`` or scalar) ->
    ``[..., 11]`` features, in the dtype and on the device of the prices."""
    p = torch.as_tensor(market_prices)
    s = torch.as_tensor(spot, dtype=p.dtype, device=p.device)
    if s.dim():
        s = s[..., None]
    grid = p.reshape(p.shape[:-1] + (_N_MATURITIES, _N_STRIKES))
    atm = grid[..., _ATM] / s                                     # [.., 3]
    skew = (grid[..., _OTM] - grid[..., _ITM]) / s                # [.., 3]
    fly = (grid[..., _ITM] + grid[..., _OTM] - 2.0 * grid[..., _ATM]) / s
    slope = atm[..., -1:] - atm[..., :1]                          # [.., 1]
    total = torch.sum(atm, dim=-1, keepdim=True)                  # [.., 1]
    return torch.cat([atm, skew, fly, slope, total], dim=-1)
